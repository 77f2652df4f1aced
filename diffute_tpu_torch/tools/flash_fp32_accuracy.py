"""How far the fp32 flash kernels and their plain fp32 versions each are
from attention computed in fp64.

  python -m diffute_tpu_torch.tools.flash_fp32_accuracy [--out FILE]

For each head_dim (64, 256, 512) at a square and a ragged shape, random
inputs from a seed: the relative L2 distance of o, dq, dk and dv (and the
max abs distance of the LSE) from fp64 autograd through plain attention,
for the kernel (``csrc/flash_fp32.cu``), its tiled plain fp32 version at
the same domain, and that plain version with its operands rounded to TF32
(what TF32 alone would give).  Prints one JSON object with the card's name
and power limit, and writes it to ``--out`` if given.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess

import torch

# (B*H, S, T) by head_dim
SHAPES = {64: [(4, 4096, 4096), (4, 1000, 577)],
          256: [(2, 4096, 4096), (2, 1000, 1500)],
          512: [(2, 4096, 4096), (2, 1000, 1500)]}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def _fp64(q, k, v, do, scale):
    q, k, v = (x.double().requires_grad_() for x in (q, k, v))
    s = torch.einsum("bsd,btd->bst", q, k) * scale
    o = torch.einsum("bst,btd->bsd", torch.softmax(s, -1), v)
    grads = torch.autograd.grad(o, (q, k, v), do.double())
    return o.detach(), torch.logsumexp(s.detach(), -1), grads


def measure(seed: int = 0) -> list:
    fa = importlib.import_module("diffute_tpu_torch.ops.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for d, shapes in SHAPES.items():
        sc, bkv = d ** -0.5, fa.FP32_BLOCK_KV[d]
        for bh, s, t in shapes:
            q, k, v, do = (torch.randn((bh, n, d), generator=g, device="cuda")
                           for n in (s, t, t, s))
            o64, lse64, grads64 = _fp64(q, k, v, do, sc)
            o, lse = fa.flash_fwd_3d(q, k, v, sc)
            dq, delta = fa.flash_bwd_dq_3d(q, k, v, o, lse, do, sc)
            kernel = (o, dq, *fa.flash_bwd_dkv_3d(q, k, v, do, lse, delta,
                                                   sc))
            row = {"shape": [bh, s, t, d]}
            for name, tf32 in (("plain", False), ("plain_tf32", True)):
                po, plse = fa.flash_fwd_tiled_reference(q, k, v, sc, bkv,
                                                        tf32=tf32)
                pg = fa.flash_bwd_tiled_reference(q, k, v, po, plse, do, sc,
                                                  bkv, tf32=tf32)
                row[name] = dict(
                    zip(("o", "dq", "dk", "dv"),
                        (_rel(x, r) for x, r in zip((po, *pg),
                                                    (o64, *grads64)))),
                    lse_abs=(plse.double() - lse64).abs().max().item())
            row["kernel"] = dict(
                zip(("o", "dq", "dk", "dv"),
                    (_rel(x, r) for x, r in zip(kernel, (o64, *grads64)))),
                lse_abs=(lse.double() - lse64).abs().max().item())
            if fa._pipelined_takes(t, d):
                po, _ = fa.flash_fwd_3d_pipelined(q, k, v, sc)
                row["kernel"]["o_deferred"] = _rel(po, o64)
            rows.append(row)
            del q, k, v, do, o64, grads64, kernel
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_fp32_accuracy: no CUDA device")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"gpu": gpu, "rows": measure()}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
