"""The port's serving example (examples/torch_serve_generator.py):
bucketed batching over a loaded torch.export program and the HTTP
surface, the four cases of tests/test_serve_example.py on the port.

The program path (export -> save -> load -> call, against JAX) is held in
tests/test_torch_port_export.py; here the serving layer on top: bucket
padding must not change results (G rows are per-sample independent),
oversized requests chunk through the top bucket, conditional programs
route labels, discriminator programs are refused, and the HTTP endpoints
round-trip images and reject malformed requests (400) apart from server
faults (500). Programs exported on the CPU from 32x32 port checkpoints.
"""

import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import examples.torch_serve_generator as serve_mod
from latentaugment_tpu_torch.models.stylegan2 import checkpoint, networks
from scripts.torch_export_model import build_export
from test_torch_port_common import _one_torch_thread  # noqa: F401 (autouse fixture)

NET = dict(img_resolution=32, img_channels=2, channel_base=256, channel_max=32)


def _artifact(d, c_dim=0, which="g", batch=0):
    ckpt = str(d / "ckpt.pkl")
    g = networks.Generator(networks.generator_config(z_dim=32, w_dim=32, c_dim=c_dim, **NET),
                           seed=0)
    dnet = networks.Discriminator(networks.discriminator_config(c_dim=c_dim, **NET), seed=1)
    checkpoint.save_checkpoint(ckpt, g, dnet)
    art = str(d / f"{which}.pt2")
    torch.export.save(build_export(ckpt, which=which, batch=batch, device="cpu"), art)
    return art


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    return _artifact(tmp_path_factory.mktemp("serve"))


@pytest.fixture(scope="module")
def cond_artifact(tmp_path_factory):
    return _artifact(tmp_path_factory.mktemp("serve_cond"), c_dim=2)


def test_bucketed_generate_pads_trims_and_chunks(artifact):
    svc = serve_mod.GeneratorService(artifact, buckets=(1, 2, 4), device="cpu")
    assert svc.z_dim == 32 and svc.c_dim == 0 and svc.platforms == ("cpu",)
    imgs3 = svc.generate(3, seed=7)   # bucket 4, trimmed to 3
    assert imgs3.shape == (3, 2, 32, 32) and imgs3.dtype == np.float32
    # Oversized request chunks through the top bucket (4 + 1).
    imgs5 = svc.generate(5, seed=7)
    assert imgs5.shape[0] == 5
    # Same seed => same z stream: bucket padding and chunk boundaries
    # must not leak into results.
    np.testing.assert_allclose(imgs5[:3], imgs3, rtol=1e-4, atol=1e-5)
    imgs1 = svc.generate(1, seed=7)   # exact bucket 1, no padding
    np.testing.assert_allclose(imgs1[0], imgs3[0], rtol=1e-4, atol=1e-5)
    # Determinism + seed sensitivity.
    np.testing.assert_array_equal(svc.generate(2, seed=3), svc.generate(2, seed=3))
    assert np.abs(svc.generate(2, seed=3) - svc.generate(2, seed=4)).max() > 1e-4
    with pytest.raises(ValueError, match="labels not accepted"):
        svc.generate(2, labels=[0, 1])
    with pytest.raises(ValueError, match="max_request_n"):
        svc.generate(10 ** 9)  # per-request memory bound
    with pytest.raises(ValueError, match="n must be"):
        svc.generate(0)


def test_discriminator_artifact_rejected(artifact, tmp_path):
    """A --which d export takes images, not z: the generator service must
    refuse it up front with a clear error, not serve nonsense; a concrete
    batch G program gets a one-bucket ladder, and a program exported on
    the CPU is not served on the card."""
    d_art = _artifact(tmp_path, which="d", batch=2)
    with pytest.raises(ValueError, match="discriminator"):
        serve_mod.GeneratorService(d_art)
    with pytest.raises(ValueError, match="exported on cpu"):
        serve_mod.GeneratorService(artifact, device="cuda")
    g2 = _artifact(tmp_path, which="g", batch=2)
    svc = serve_mod.GeneratorService(g2, device="cpu")
    assert svc.buckets == (2,) and svc.generate(3, seed=1).shape[0] == 3


def test_conditional_artifact_routes_labels(cond_artifact):
    svc = serve_mod.GeneratorService(cond_artifact, buckets=(1, 2, 4), device="cpu")
    assert svc.c_dim == 2
    a = svc.generate(2, seed=5, labels=[0, 1])
    b = svc.generate(2, seed=5, labels=[1, 1])
    assert a.shape[0] == 2
    # The label changes the image (the mapping's embed is live).
    assert np.abs(a[0] - b[0]).max() > 1e-4
    np.testing.assert_allclose(a[1], b[1], rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="labels"):
        svc.generate(2, seed=5)                 # missing labels
    with pytest.raises(ValueError, match="length"):
        svc.generate(2, seed=5, labels=[0])     # wrong length
    with pytest.raises(ValueError, match="ids"):
        svc.generate(1, seed=5, labels=[9])     # out of range


def test_http_surface_roundtrip_and_errors(artifact):
    service, httpd = serve_mod.serve(artifact, port=0, buckets=(1, 2, 4), device="cpu")
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        meta = json.loads(urllib.request.urlopen(f"{url}/healthz").read())
        assert meta == dict(z_dim=32, c_dim=0, buckets=[1, 2, 4], platforms=["cpu"])

        req = urllib.request.Request(
            f"{url}/generate", data=json.dumps(dict(n=3, seed=7)).encode(),
            headers={"Content-Type": "application/json"})
        resp = json.loads(urllib.request.urlopen(req).read())
        imgs = np.load(io.BytesIO(base64.b64decode(resp["images_b64"])))
        assert list(imgs.shape) == resp["shape"] and imgs.shape[0] == 3
        assert resp["dtype"] == "float32"
        # HTTP result == direct service result (same seed/stream).
        np.testing.assert_allclose(imgs, service.generate(3, seed=7), rtol=1e-4, atol=1e-5)

        # Every malformed body answers 400 (never a dropped connection):
        # labels on an unconditional artifact, a non-object JSON body,
        # and a null n.
        for body in (dict(n=2, labels=[0, 1]), [1, 2], dict(n=None)):
            bad = urllib.request.Request(
                f"{url}/generate", data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"})
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(bad)
            assert ei.value.code == 400, body

        # Transport-level abuse is rejected before the body is read: an
        # empty body and an unknown field answer 400; an oversized
        # declared body answers 400 without being read into memory.
        for data in (b"", json.dumps(dict(n=1, evil=1)).encode()):
            bad = urllib.request.Request(f"{url}/generate", data=data)
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(bad)
            assert ei.value.code == 400, data
        big = urllib.request.Request(
            f"{url}/generate", data=b'{"n": 1}',
            headers={"Content-Length": str(64 << 20)})
        with pytest.raises((urllib.error.HTTPError, ConnectionError,
                            urllib.error.URLError)) as ei:
            urllib.request.urlopen(big, timeout=10)
        if isinstance(ei.value, urllib.error.HTTPError):
            assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{url}/nothing")
        assert ei.value.code == 404

        # A server fault answers 500, not a 400 blamed on the client.
        orig = service.generate
        service.generate = lambda *a, **k: (_ for _ in ()).throw(
            RuntimeError("injected server bug"))
        try:
            bad = urllib.request.Request(
                f"{url}/generate", data=json.dumps(dict(n=1)).encode())
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(bad)
            assert ei.value.code == 500
            assert "injected server bug" in json.loads(ei.value.read())["error"]
        finally:
            service.generate = orig
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_selftest_serves_a_synthetic_checkpoint(capsys):
    imgs = serve_mod.main(["--selftest", "--device", "cpu"])
    assert imgs.shape == (3, 2, 32, 32)
    assert "[serve] selftest OK" in capsys.readouterr().out
