"""PyTorch port, manifest datasets and blob storage, against the JAX package
(which reads manifests with pandas and decodes with cv2 / libjpeg-turbo).

- ``read_manifest`` gives ``pd.read_csv``'s path columns.
- ``decode_image``: PNG equal to cv2 bit for bit; JPEG (both sides
  libjpeg-turbo: the port through Pillow, JAX through the native decoder)
  within 1 LSB, which measured 0 when this was written.
- ``UNetManifestDataset`` and ``VAEManifestDataset`` items equal JAX's bit
  for bit at the same seed, pages whose short side is under 512 (upscaled by
  ``int(1024 / short)``) included, and a JPEG page within 1 LSB; JAX's
  uint8 resize is held on its native route, the port's arithmetic (its cv2
  route is within 1 LSB of it on upscales, ``tests/test_hostops.py``).
- ``PrefetchLoader`` substitutes failing examples as JAX's does.
- ``run_unet --manifest`` and ``run_vae --manifest`` train on the CPU.
- ``io/oss.py`` against a copy of the fake OSS server of
  ``tests/test_storage_oss.py``, which verifies the request signature.
"""

import base64
import hashlib
import hmac
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import cv2
import numpy as np
import pandas as pd
import pytest
from PIL import Image

from diffute_tpu.config import DiffUTEConfig as JConfig
from diffute_tpu.io import dataset as jdataset
from diffute_tpu.io import hostops as jhostops
from diffute_tpu.io import storage as jstorage

from diffute_tpu_torch.config import DiffUTEConfig
from diffute_tpu_torch.io import dataset, storage
from diffute_tpu_torch.io.oss import OSSClient, read_through_cache, register_oss
from diffute_tpu_torch.train import run_unet, run_vae

PAGES = [(300, 400), (600, 700), (520, 380)]  # (H, W): two short sides < 512
WORDS = ["INVOICE", "Total 42.00", "hello"]


def _page(i, h, w):
    rng = np.random.RandomState(i)
    img = np.full((h, w, 3), 230, np.uint8)
    img[20:h - 20, 30:w - 30] = rng.randint(0, 255, (h - 40, w - 60, 3))
    return img


@pytest.fixture(scope="module")
def manifests(tmp_path_factory):
    """PNG pages (one JPEG), OCR JSON files and the two manifests."""
    root = tmp_path_factory.mktemp("manifest")
    rows = []
    for i, (h, w) in enumerate(PAGES):
        img = _page(i, h, w)
        ext = ".jpg" if i == 2 else ".png"
        path = str(root / f"page {i}{ext}")  # a space, as real scans have
        Image.fromarray(img).save(path, quality=90)
        ocr = str(root / f"page{i}.json")
        regions = [{"text": WORDS[i], "score": 0.95,
                    "box": [[40, 50], [200, 50], [200, 90], [40, 90]]},
                   {"text": "low", "score": 0.5,
                    "box": [[10, 10], [50, 10], [50, 30], [10, 30]]},
                   {"text": "second", "score": 0.9,
                    "box": [[60, 120], [180, 118], [182, 150], [61, 152]]}]
        with open(ocr, "w") as f:
            json.dump({"document": regions}, f)
        rows.append((path, ocr))
    unet_csv, vae_csv = str(root / "doc_select.csv"), str(root / "pages.csv")
    with open(unet_csv, "w") as f:
        f.write("image_path,ocr_path,note\n\n")
        for path, ocr in rows:
            f.write(f'"{path}",{ocr},"a, quoted note"\n')
    with open(vae_csv, "w", encoding="utf-8-sig") as f:  # with a BOM
        f.write("path\n" + "".join(f"{p}\n" for p, _ in rows))
    return unet_csv, vae_csv


def test_read_manifest_matches_pandas(manifests):
    for csv in manifests:
        mine = dataset.read_manifest(csv)
        df = pd.read_csv(csv, low_memory=False)
        assert list(mine) == list(df.columns)
        for col in mine:
            assert mine[col] == df[col].tolist()


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "P"])
def test_png_decodes_as_cv2(mode):
    img = Image.fromarray(_page(5, 60, 80)).convert(mode)
    buf = io.BytesIO()
    img.save(buf, "PNG")
    data = buf.getvalue()
    ref = cv2.imdecode(np.frombuffer(data, np.uint8), flags=1)  # BGR
    np.testing.assert_array_equal(storage.decode_image(data, bgr=True), ref)
    np.testing.assert_array_equal(storage.decode_image(data),
                                  cv2.cvtColor(ref, cv2.COLOR_BGR2RGB))
    np.testing.assert_array_equal(storage.decode_image(data),
                                  jstorage.decode_image(data))


@pytest.mark.parametrize("quality,subsampling", [(75, 2), (95, 0)])
def test_jpeg_decode_within_one_lsb_of_jax(quality, subsampling):
    buf = io.BytesIO()
    Image.fromarray(_page(6, 120, 160)).save(buf, "JPEG", quality=quality,
                                             subsampling=subsampling)
    data = buf.getvalue()
    for bgr in (False, True):
        a = storage.decode_image(data, bgr=bgr).astype(np.int16)
        b = jstorage.decode_image(data, bgr=bgr)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1


def test_decode_errors_and_blob_schemes(tmp_path):
    with pytest.raises(ValueError, match="Failed to decode"):
        storage.decode_image(b"not an image")
    p = tmp_path / "x.bin"
    p.write_bytes(b"abc")
    with storage.open_blob(f"file://{p}") as f:
        assert f.read() == b"abc"
    storage.register_opener("mem", lambda url: io.BytesIO(url.encode()))
    try:
        with storage.open_blob("mem://k") as f:
            assert f.read() == b"mem://k"
    finally:
        storage._OPENERS.pop("mem")
    with pytest.raises(ValueError, match="x.bin"):
        storage.read_image(str(p))


def test_unet_manifest_items_equal_jax(manifests, monkeypatch):
    mine = dataset.UNetManifestDataset(manifests[0], DiffUTEConfig(), seed=3)
    ref = jdataset.UNetManifestDataset(manifests[0], JConfig(), seed=3)
    assert len(mine) == len(ref) == len(PAGES)
    items = [mine[i] for i in range(len(PAGES))]
    for route in ("cv2", "native"):
        if route == "native":
            monkeypatch.setattr(jhostops, "cv2", None)
        for i, a in enumerate(items):
            b = ref[i]
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                diff = np.abs(a[k].astype(np.int16) - b[k]).max()
                # 2 is the JPEG page
                exact = route == "native" and i != 2
                assert diff <= (0 if exact else 1), (route, i, k, diff)


def test_vae_manifest_items_equal_jax_with_upscale(manifests, monkeypatch):
    monkeypatch.setattr(jhostops, "cv2", None)
    mine = dataset.VAEManifestDataset(manifests[1], DiffUTEConfig(), seed=1)
    ref = jdataset.VAEManifestDataset(manifests[1], JConfig(), seed=1)
    for i in range(len(PAGES)):
        a, b = mine[i]["pixel_values"], ref[i]["pixel_values"]
        assert a.shape == b.shape == (512, 512, 3)
        assert np.abs(a.astype(np.int16) - b).max() <= (1 if i == 2 else 0)
    bgr = dataset.VAEManifestDataset(manifests[1], DiffUTEConfig(), seed=1,
                                     bgr=True)
    np.testing.assert_array_equal(bgr[0]["pixel_values"],
                                  mine[0]["pixel_values"][..., ::-1])
    batch = dataset.make_vae_batch([mine[0], mine[1]])
    assert batch["pixel_values"].shape == (2, 512, 512, 3)
    np.testing.assert_array_equal(
        batch["pixel_values"], jdataset.make_vae_batch([ref[0], ref[1]])[
            "pixel_values"])


class _Flaky:
    """Index i; every third index fails."""

    def __len__(self):
        return 10

    def __getitem__(self, i):
        if i % 3 == 0:
            raise OSError(f"corrupt blob {i}")
        return {"i": np.int64(i)}


def test_prefetch_loader_substitutes_as_jax():
    def collate(ex):
        return np.stack([e["i"] for e in ex])

    out = []
    for module in (dataset, jdataset):
        loader = module.PrefetchLoader(_Flaky(), 4, collate, num_threads=1,
                                       seed=5, num_epochs=2)
        out.append(([b.tolist() for b in loader], loader.error_count))
    assert out[0] == out[1]
    assert out[0][1] > 0 and all(i % 3 for b in out[0][0] for i in b)


def test_run_entry_points_train_on_manifests(manifests, tmp_path):
    common = ["--device", "cpu", "--smoke", "--dataloader_num_workers", "1",
              "--report_to", "none"]
    history = run_unet.main([*common, "--manifest", manifests[0],
                             "--output_dir", str(tmp_path / "unet")])
    assert [h["step"] for h in history] == [1, 2]
    history = run_vae.main([*common, "--manifest", manifests[1],
                            "--output_dir", str(tmp_path / "vae")])
    assert [h["step"] for h in history] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert (tmp_path / "vae" / "checkpoint-2" / "vae" / "config.json").exists()


# ---------------------------------------------- oss:// against a fake server

KEY_ID, SECRET = "test-key-id", "test-secret"


class _FakeOSS(BaseHTTPRequestHandler):
    blobs = {}
    require_auth = True
    hits = []

    def do_GET(self):
        self.__class__.hits.append(self.path)
        if self.require_auth:
            date = self.headers.get("Date", "")
            to_sign = f"GET\n\n\n{date}\n{self.path}"
            want = "OSS %s:%s" % (KEY_ID, base64.b64encode(
                hmac.new(SECRET.encode(), to_sign.encode(),
                         hashlib.sha1).digest()).decode())
            if self.headers.get("Authorization") != want:
                self.send_response(403)
                self.end_headers()
                return
        blob = self.blobs.get(self.path)
        if blob is None:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(blob)))
        self.end_headers()
        self.wfile.write(blob)

    def log_message(self, *a):  # quiet
        pass


@pytest.fixture()
def fake_oss():
    _FakeOSS.blobs = {"/bkt/data/hello.txt": b"hello oss"}
    _FakeOSS.hits = []
    _FakeOSS.require_auth = True
    server = HTTPServer(("127.0.0.1", 0), _FakeOSS)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_port}"
    server.shutdown()
    storage._OPENERS.pop("oss", None)


def _client(endpoint, **kw):
    return OSSClient(endpoint, KEY_ID, SECRET, path_style=True, **kw)


def test_oss_signed_get_and_refusals(fake_oss):
    assert _client(fake_oss).get("oss://bkt/data/hello.txt") == b"hello oss"
    with pytest.raises(PermissionError):
        OSSClient(fake_oss, KEY_ID, "wrong-secret", path_style=True).get(
            "oss://bkt/data/hello.txt")
    with pytest.raises(FileNotFoundError):
        _client(fake_oss).get("oss://bkt/nope.txt")


def test_oss_anonymous_get_and_quoted_keys(fake_oss):
    _FakeOSS.require_auth = False
    _FakeOSS.blobs["/bkt/scans/%E5%8F%91%E7%A5%A8%202023.png"] = b"img"
    c = OSSClient(fake_oss, access_key_id=None, access_key_secret=None,
                  path_style=True)
    assert c.get("oss://bkt/data/hello.txt") == b"hello oss"
    assert c.get("oss://bkt/scans/发票 2023.png") == b"img"


def test_oss_url_parsing_and_styles():
    assert OSSClient.parse("oss://b/k/with/slashes") == ("b", "k/with/slashes")
    for bad in ("oss://bucket-only", "gs://b/k"):
        with pytest.raises(ValueError):
            OSSClient.parse(bad)
    c = OSSClient("oss-cn-x.aliyuncs.com", "i", "s")
    assert c.url_for("bkt", "k") == "https://bkt.oss-cn-x.aliyuncs.com/k"
    c = OSSClient("http://127.0.0.1:1", "i", "s", path_style=True)
    assert c.url_for("bkt", "k") == "http://127.0.0.1:1/bkt/k"


def test_oss_scheme_feeds_read_image_through_the_cache(fake_oss, tmp_path):
    img = np.zeros((8, 8, 3), np.uint8)
    img[:, :, 0] = 200  # red in RGB
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    _FakeOSS.blobs["/bkt/img.png"] = buf.getvalue()
    register_oss(fake_oss, KEY_ID, SECRET, path_style=True,
                 cache_dir=str(tmp_path))
    assert storage.read_image("oss://bkt/img.png")[0, 0, 0] == 200
    hits = len(_FakeOSS.hits)
    with storage.open_blob("oss://bkt/img.png") as f:
        assert f.read() == buf.getvalue()
    assert len(_FakeOSS.hits) == hits  # served from the cache
    cached = read_through_cache(_client(fake_oss).opener(), str(tmp_path / "c"))
    for _ in range(3):
        assert cached("oss://bkt/data/hello.txt").read() == b"hello oss"
    assert len(_FakeOSS.hits) == hits + 1
