"""PyTorch port: the stdlib web demo (``serve/web.py``) and its UI callbacks
(``serve/ui.py``), served on the CPU at tiny width and driven over HTTP.

The cases of tests/test_serve_web.py and tests/test_serve_ui.py against the
port's own copies, ``select_coordinates`` and ``make_examples`` held to the
JAX package's on the same inputs, the device rule of ``build_pipeline``, and
a subprocess check that the server imports neither jax nor the JAX package.
"""

import base64
import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from diffute_tpu.serve import ui as j_ui

from diffute_tpu_torch.serve import ui, web
from port_threads import torch_threads_per_worker  # noqa: F401


@pytest.fixture(scope="module")
def pipe():
    return web.build_pipeline(None, "tiny", device="cpu")


@pytest.fixture(scope="module")
def server_url(pipe, tmp_path_factory):
    backend = web.DemoBackend(
        pipe, examples_dir=str(tmp_path_factory.mktemp("examples")))
    server = web.make_server(backend, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    host, port = server.server_address[:2]
    yield f"http://{host}:{port}"
    server.shutdown()
    server.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def _post(url, payload):
    body = payload if isinstance(payload, bytes) else json.dumps(
        payload).encode()
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _decode_b64_png(data_url):
    b64 = data_url.split(",", 1)[-1]
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def _data_url(img):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return ("data:image/png;base64,"
            + base64.b64encode(buf.getvalue()).decode())


def test_index_page_serves(server_url):
    status, ctype, body = _get(server_url + "/")
    assert status == 200 and "text/html" in ctype
    page = body.decode()
    assert "DiffUTE" in page
    assert 'min="20" max="200"' in page and 'value="150"' in page
    for widget in ("x0", "y0", "x1", "y1", "sampler", "examples"):
        assert f'id="{widget}"' in page


def test_examples_gallery(server_url):
    status, _, body = _get(server_url + "/api/examples")
    assert status == 200
    j = json.loads(body)
    assert j["samplers"] == ["ddim", "ddpm", "dpmpp"]
    assert len(j["examples"]) == 4
    row = j["examples"][0]
    assert set(row) == {"text", "image", "steps", "box"}
    status, ctype, png = _get(server_url + row["image"])
    assert status == 200 and ctype == "image/png"
    img = np.asarray(Image.open(io.BytesIO(png)))
    assert img.ndim == 3 and img.shape[2] == 3


@pytest.mark.parametrize("path", ["/examples/%2e%2e%2fweb.py",
                                  "/examples/nothing.png", "/api/nothing"])
def test_unknown_paths_are_404(server_url, path):
    with pytest.raises(urllib.error.HTTPError) as exc:
        _get(server_url + path)
    assert exc.value.code == 404


def test_two_click_roi_protocol(server_url):
    status, j1 = _post(server_url + "/api/click",
                       {"state": None, "xy": [100, 90], "hw": [200, 400]})
    assert status == 200 and not j1["ready"]
    assert j1["sections"][0]["label"] == ui.POINT_LABEL
    status, j2 = _post(server_url + "/api/click",
                       {"state": j1["state"], "xy": [20, 130],
                        "hw": [200, 400]})
    assert status == 200 and j2["ready"]
    assert j2["sections"][0]["label"] == ui.ROI_LABEL
    assert j2["box"] == [20, 90, 100, 130]  # corners sorted


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp", None])
def test_edit_endpoint_end_to_end(server_url, pipe, sampler):
    img = np.random.RandomState(0).randint(0, 255, (120, 160, 3), np.uint8)
    payload = {"image": _data_url(img), "text": "GPU", "steps": 2,
               "box": [40, 50, 100, 70]}
    if sampler:
        payload["sampler"] = sampler
    status, j = _post(server_url + "/api/edit", payload)
    assert status == 200, j
    out = _decode_b64_png(j["image"])
    mask = _decode_b64_png(j["mask"])
    assert out.shape == img.shape and out.dtype == np.uint8
    assert mask.shape[:2] == img.shape[:2]
    assert set(np.unique(mask)) <= {0, 255}  # mask*255, like the reference
    outside = np.ones(img.shape[:2], bool)
    outside[50:70, 40:100] = False
    np.testing.assert_array_equal(out[outside], img[outside])
    assert (out[~outside] != img[~outside]).any()
    # the server answers what the pipeline's edit() gives
    import dataclasses

    ec = dataclasses.replace(pipe.config.edit, sampler=sampler or "ddim")
    ref, _ = pipe.edit(img, (40, 50, 100, 70), "GPU", num_inference_steps=2,
                       edit_config=ec)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("bad", [
    {"text": "", "steps": 2, "box": [1, 1, 30, 30]},       # empty text
    {"text": "x", "steps": 2, "box": [10, 10, 10, 40]},    # degenerate box
    {"text": "x", "steps": 2, "sampler": "euler", "box": [1, 1, 30, 30]},
    {"text": "x", "image": None},                           # no image
    b"{not json"])
def test_edit_errors_are_400(server_url, bad):
    if isinstance(bad, dict) and "image" not in bad:
        bad = dict(bad, image=_data_url(np.zeros((64, 64, 3), np.uint8)))
    elif isinstance(bad, dict):
        del bad["image"]
    status, j = _post(server_url + "/api/edit", bad)
    assert status == 400 and "error" in j


# ---- serve/ui.py against the JAX package's, on the same inputs


def test_select_coordinates_equals_jax_package():
    rng = np.random.RandomState(0)
    s, js = ui.initial_roi_state(), j_ui.initial_roi_state()
    assert s == js
    for _ in range(7):
        xy = tuple(int(v) for v in rng.randint(0, 300, 2))
        hw = tuple(int(v) for v in rng.randint(50, 600, 2))
        s, sections, box = ui.select_coordinates(s, xy, hw)
        js, j_sections, j_box = j_ui.select_coordinates(js, xy, hw)
        assert (s, sections, box) == (js, j_sections, j_box)
        assert ui.roi_ready(s) == j_ui.roi_ready(js)
    assert (ui.ROI_LABEL, ui.POINT_LABEL) == (j_ui.ROI_LABEL, j_ui.POINT_LABEL)


def test_state_is_per_user_not_shared():
    a, b = ui.initial_roi_state(), ui.initial_roi_state()
    a2, _, _ = ui.select_coordinates(a, (5, 5), (100, 100))
    assert b["clicks"] == 0 and a["clicks"] == 0  # inputs not mutated
    assert a2["clicks"] == 1 and not ui.roi_ready(a2)


def test_make_examples_equals_jax_package(tmp_path):
    rows = ui.make_examples(str(tmp_path / "t"), seed=2)
    j_rows = j_ui.make_examples(str(tmp_path / "j"), seed=2)
    assert len(rows) == len(j_rows) == 4
    for row, j_row in zip(rows, j_rows):
        assert row[0] == j_row[0] and row[2:] == j_row[2:]
        assert os.path.basename(row[1]) == os.path.basename(j_row[1])
        img, j_img = (np.asarray(Image.open(r[1])) for r in (row, j_row))
        np.testing.assert_array_equal(img, j_img)
        _, _, steps, x0, y0, x1, y1 = row
        assert 20 <= steps <= 200 and 0 <= x0 < x1 <= img.shape[1]
        assert 0 <= y0 < y1 <= img.shape[0]


def test_run_edit_argument_order_validation_and_sampler(pipe):
    calls = {}

    class FakePipe:
        config = pipe.config

        def edit(self, image, box, text, num_inference_steps,
                 edit_config=None):
            calls.update(box=box, text=text, steps=num_inference_steps,
                         sampler=edit_config and edit_config.sampler)
            return image, np.zeros(image.shape[:2], np.uint8)

    img = np.zeros((32, 48, 3), np.uint8)
    out, mask = ui.run_edit(FakePipe(), img, "HELLO", 150.0, 1, 2, 20, 21)
    assert calls == dict(box=(1, 2, 20, 21), text="HELLO", steps=150,
                         sampler=None)
    assert out.shape == img.shape and mask.shape == img.shape[:2]
    ui.run_edit(FakePipe(), img, "X", 20, 0, 0, 4, 4, sampler="dpmpp")
    assert calls["sampler"] == "dpmpp"
    with pytest.raises(ValueError):
        ui.run_edit(FakePipe(), None, "x", 50, 0, 0, 1, 1)
    with pytest.raises(ValueError):
        ui.run_edit(FakePipe(), img, "", 50, 0, 0, 1, 1)


# ---- the device rule, and what the server imports


def test_build_pipeline_defaults_to_the_card(pipe):
    assert pipe.device.type == "cpu"
    assert pipe.config.unet.dtype == torch.float32
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default does not raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        web.build_pipeline(None, "tiny")
    with pytest.raises(SystemExit, match="no CUDA device"):
        web.main(["--scale", "tiny", "--port", "0"])


def test_checkpoint_loads_a_diffusers_layout(tmp_path):
    from diffute_tpu_torch.compat.diffusers import diffusers_unet_config_json
    from diffute_tpu_torch.config import tiny_test_config
    from diffute_tpu_torch.train.checkpoint import export_diffusers_layout
    from diffute_tpu_torch.utils import init_pipeline_params

    cfg = tiny_test_config()
    params = init_pipeline_params(cfg, seed=9, device="cpu")
    export_diffusers_layout(str(tmp_path), unet_params=params["unet"],
                            unet_config=diffusers_unet_config_json(cfg.unet))
    pipe = web.build_pipeline(str(tmp_path), None, device="cpu")
    # the scale comes from unet/config.json; the VAE and the TrOCR encoder,
    # which the directory lacks, are random-init from seed 0
    assert pipe.config.edit.resolution == cfg.edit.resolution
    assert torch.equal(pipe.unet.conv_in.weight, params["unet"]["conv_in.weight"])
    with pytest.raises(SystemExit, match="no checkpoint directory"):
        web.main(["--checkpoint", str(tmp_path / "missing"), "--device", "cpu"])


def test_server_imports_no_jax():
    code = (
        "import sys\n"
        "import diffute_tpu_torch.serve.web, diffute_tpu_torch.serve.ui\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'diffute_tpu', 'cv2'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


@pytest.mark.cuda
def test_cuda_server_edits_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    backend = web.DemoBackend(web.build_pipeline(None, "small"))
    assert backend.pipe.device.type == "cuda"
    assert backend.pipe.config.unet.dtype == torch.bfloat16
    img = np.random.RandomState(0).randint(0, 255, (300, 400, 3), np.uint8)
    j = backend.handle_edit({"image": _data_url(img), "text": "GPU",
                             "steps": 4, "box": [100, 120, 260, 170]})
    out = _decode_b64_png(j["image"])
    outside = np.ones(img.shape[:2], bool)
    outside[120:170, 100:260] = False
    np.testing.assert_array_equal(out[outside], img[outside])
    assert (out[~outside] != img[~outside]).any()


@pytest.mark.cuda
def test_cuda_edit_stream_equals_sequential_edits():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc")
    import dataclasses

    from diffute_tpu_torch.config import card_serving_config, small_config
    from diffute_tpu_torch.pipeline import DiffUTEPipeline
    from diffute_tpu_torch.utils import init_pipeline_params

    cfg = card_serving_config(small_config())
    cfg = dataclasses.replace(cfg, unet=dataclasses.replace(
        cfg.unet, use_fused_groupnorm=True, use_fused_conv=True,
        use_int8_weights=True))
    pipe = DiffUTEPipeline(cfg, init_pipeline_params(cfg, 0, "cuda"))
    rng = np.random.RandomState(3)
    items = [(rng.randint(0, 256, (300, 400, 3)).astype(np.uint8),
              (100 + 10 * i, 120, 260, 170), f"t{i}") for i in range(4)]
    seq = [pipe.edit(*item, num_inference_steps=6)[0] for item in items]
    for depth in (2, 1):
        streamed = list(pipe.edit_stream(items, num_inference_steps=6,
                                         depth=depth))
        assert len(streamed) == len(seq)
        for a, b in zip(streamed, seq):
            np.testing.assert_array_equal(a, b)
