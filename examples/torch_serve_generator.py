"""Serving-edge example: an HTTP generator service over an exported
`torch.export` program (the port's copy of examples/serve_generator.py).
No model source and no pickle at the edge.

    python scripts/torch_export_model.py --checkpoint ckpt.pkl --out g.pt2
    python examples/torch_serve_generator.py --artifact g.pt2 --port 8000

The server loads the program (weights in its state) with
`torch.export.load` and calls it. The edge needs PyTorch and the port's
`ops` package: its import registers the kernels' custom ops
(`latentaugment_torch::*`) that the program calls, and their first launch
builds the kernels. A program exported on the card is served on the card
(`--device cuda`, the default); one exported with `--device cpu` on the
CPU.

Bucketed batching: the program has a symbolic batch dimension, and the
server still pads every request up to a fixed bucket ladder (powers of
two) and trims the response, so the card sees a handful of batch sizes;
each bucket's first call (its kernels' builds and Triton compiles) runs
alone. Requests larger than the top bucket are chunked through it.

API (JSON over HTTP):
    GET  /healthz            -> {"z_dim", "c_dim", "buckets", "platforms"}
    POST /generate           -> {"shape", "dtype", "images_b64"}
        body {"n": 3, "seed": 7, "labels": [0, 1, 0]?}
        images_b64 = base64 of an .npy blob (np.load round-trips it)
z is drawn from np.random.RandomState(seed), as the JAX example draws
it, so one seed gives the same z in both.

Smoke demo on a synthetic checkpoint (also the tests' path):
    python examples/torch_serve_generator.py --selftest --device cpu
"""

import argparse
import base64
import io
import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from scripts.torch_export_model import input_shapes


def program_device(program):
    """The device of the program's weights."""
    for t in program.state_dict.values():
        return t.device
    raise ValueError('the program holds no weights')


class GeneratorService:
    """A loaded program + bucketed batching. Thread-safe: only a bucket's
    first call (its kernels' builds) is serialized; steady-state requests
    run concurrently."""

    def __init__(self, artifact_path, buckets=(1, 2, 4, 8, 16, 32),
                 max_request_n=1024, device=None):
        import latentaugment_tpu_torch.ops  # noqa: F401 (registers the custom ops)

        self.program = torch.export.load(artifact_path)
        avals = input_shapes(self.program)
        if len(avals[0]) != 2:
            # A --which d export takes [B,C,H,W] images; this example is
            # a GENERATOR service (z -> images) and cannot serve it.
            raise ValueError(
                f'expected a generator artifact with a [batch, z_dim] '
                f'input, got input shape {tuple(avals[0])} — a '
                f'discriminator export is not servable here')
        self.device = program_device(self.program)
        if device is not None and torch.device(device).type != self.device.type:
            raise ValueError(f'the artifact was exported on {self.device.type}; '
                             f'it cannot be served on {device}')
        self.module = self.program.module()
        self.z_dim = int(avals[0][1])
        self.c_dim = int(avals[1][1]) if len(avals) > 1 else 0
        lead = avals[0][0]
        if isinstance(lead, int):
            # Concrete-batch G artifact (--batch N export): one bucket.
            self.buckets = (int(lead),)
        else:
            self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.max_request_n = int(max_request_n)
        self.platforms = (self.device.type,)
        # One lock per bucket: a cold bucket's first call must not queue
        # behind an unrelated bucket's. The ladder is fixed at
        # construction, so the dict needs no guard.
        self._compile_locks = {b: threading.Lock() for b in self.buckets}
        self._compiled = set()

    def _run(self, z, c):
        args = [torch.from_numpy(z).to(self.device)]
        if self.c_dim:
            args.append(torch.from_numpy(c).to(self.device))
        with torch.no_grad():
            return self.module(*args).float().cpu().numpy()

    def _call(self, z, c):
        bucket = z.shape[0]
        if bucket not in self._compiled:
            with self._compile_locks[bucket]:
                if bucket not in self._compiled:
                    out = self._run(z, c)
                    self._compiled.add(bucket)
                    return out
        return self._run(z, c)

    def generate(self, n, seed=0, labels=None):
        """[n, C, H, W] float32 images for seeded z draws. `labels`:
        int class ids, length n (required iff the artifact is
        conditional)."""
        if n < 1:
            raise ValueError('n must be >= 1')
        if n > self.max_request_n:
            # Bound per-request host memory (z draws + accumulated
            # output chunks); clients page through seeds instead.
            raise ValueError(f'n {n} > max_request_n '
                             f'{self.max_request_n}')
        if self.c_dim and labels is None:
            raise ValueError(f'conditional artifact: labels (len {n}, '
                             f'ids < {self.c_dim}) required')
        if not self.c_dim and labels is not None:
            raise ValueError('unconditional artifact: labels not accepted')
        if labels is not None and len(labels) != n:
            raise ValueError(f'labels length {len(labels)} != n {n}')
        rng = np.random.RandomState(seed)
        z_all = rng.randn(n, self.z_dim).astype(np.float32)
        c_all = None
        if self.c_dim:
            ids = np.asarray(labels, dtype=np.int64)
            if (ids < 0).any() or (ids >= self.c_dim).any():
                raise ValueError(f'label ids must be in [0, {self.c_dim})')
            c_all = np.eye(self.c_dim, dtype=np.float32)[ids]

        top = self.buckets[-1]
        outs = []
        start = 0
        while start < n:
            m = min(n - start, top)
            bucket = next(b for b in self.buckets if b >= m)
            z = np.zeros((bucket, self.z_dim), np.float32)
            z[:m] = z_all[start:start + m]
            c = None
            if self.c_dim:
                # Pad rows with a valid one-hot (class 0); trimmed below.
                c = np.zeros((bucket, self.c_dim), np.float32)
                c[:, 0] = 1.0
                c[:m] = c_all[start:start + m]
            outs.append(self._call(z, c)[:m])
            start += m
        return np.concatenate(outs, axis=0)


def _npy_b64(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return base64.b64encode(buf.getvalue()).decode('ascii')


def make_handler(service):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/healthz':
                return self._send(200, dict(
                    z_dim=service.z_dim, c_dim=service.c_dim,
                    buckets=list(service.buckets),
                    platforms=list(service.platforms)))
            return self._send(404, dict(error='not found'))

        # A /generate body is a tiny JSON dict; anything bigger is a
        # mistake or abuse. Reject before reading, so that a missing or
        # absurd Content-Length cannot exhaust host memory, and bound every
        # socket read with a timeout, so that a lying under-limit
        # Content-Length cannot pin a server thread forever.
        MAX_BODY = 1 << 20
        timeout = 30  # BaseHTTPRequestHandler: per-connection socket timeout

        def _parse_request(self):
            """Validate transport and fields; raises ValueError (-> 400)
            on anything the client got wrong, so that the except below
            stays narrow and server bugs surface as 500s."""
            try:
                length = int(self.headers.get('Content-Length') or '')
            except ValueError:
                raise ValueError('Content-Length required')
            if length <= 0:
                raise ValueError('Content-Length must be positive')
            if length > self.MAX_BODY:
                raise ValueError(f'request body > {self.MAX_BODY} bytes')
            try:
                req = json.loads(self.rfile.read(length))
            except (json.JSONDecodeError, UnicodeDecodeError):
                raise ValueError('body is not valid JSON')
            if not isinstance(req, dict):
                raise ValueError('body must be a JSON object')
            unknown = set(req) - {'n', 'seed', 'labels'}
            if unknown:
                raise ValueError(f'unknown fields: {sorted(unknown)}')
            n, seed = req.get('n', 1), req.get('seed', 0)
            if not isinstance(n, int) or isinstance(n, bool):
                raise ValueError('n must be an integer')
            if not isinstance(seed, int) or isinstance(seed, bool):
                raise ValueError('seed must be an integer')
            labels = req.get('labels')
            if labels is not None:
                if not isinstance(labels, list) or \
                        not all(isinstance(x, int) and
                                not isinstance(x, bool) for x in labels):
                    raise ValueError('labels must be a list of ints')
            return n, seed, labels

        def do_POST(self):
            if self.path != '/generate':
                return self._send(404, dict(error='not found'))
            try:
                n, seed, labels = self._parse_request()
                imgs = service.generate(n, seed=seed, labels=labels)
            except ValueError as e:   # client errors only (see above)
                return self._send(400, dict(error=str(e)))
            except Exception as e:    # noqa: BLE001 — a bug in the
                # service must answer 500, not masquerade as a client
                # error or drop the connection with a raw traceback.
                return self._send(500, dict(
                    error=f'{type(e).__name__}: {e}'))
            return self._send(200, dict(
                shape=list(imgs.shape), dtype=str(imgs.dtype),
                images_b64=_npy_b64(imgs)))

        def log_message(self, fmt, *a):  # quiet by default
            if os.environ.get('LATAUG_SERVE_VERBOSE'):
                super().log_message(fmt, *a)

    return Handler


def serve(artifact, host='127.0.0.1', port=8000,
          buckets=(1, 2, 4, 8, 16, 32), max_request_n=1024, device=None):
    """Build the service and a bound ThreadingHTTPServer (not started)."""
    service = GeneratorService(artifact, buckets=buckets,
                               max_request_n=max_request_n, device=device)
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    return service, httpd


def _selftest(device):
    """End to end on a synthetic checkpoint: a 32x32 StyleGAN2 G written
    as a native checkpoint, exported, served on port 0, one request."""
    import tempfile
    import urllib.request

    from latentaugment_tpu_torch.models.stylegan2 import checkpoint, networks
    from scripts.torch_export_model import build_export

    d = tempfile.mkdtemp(prefix='lataug_torch_serve_')
    ckpt = os.path.join(d, 'ckpt.pkl')
    g_cfg = networks.generator_config(img_resolution=32, img_channels=2, z_dim=32, w_dim=32,
                                      channel_base=256, channel_max=32)
    checkpoint.save_checkpoint(ckpt, networks.Generator(g_cfg, seed=0))
    art = os.path.join(d, 'g.pt2')
    torch.export.save(build_export(ckpt, which='g', device=device), art)
    service, httpd = serve(art, port=0, buckets=(1, 2, 4), device=device)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f'http://127.0.0.1:{httpd.server_address[1]}'
        meta = json.loads(urllib.request.urlopen(f'{url}/healthz').read())
        req = urllib.request.Request(
            f'{url}/generate', data=json.dumps(dict(n=3, seed=7)).encode(),
            headers={'Content-Type': 'application/json'})
        resp = json.loads(urllib.request.urlopen(req).read())
        imgs = np.load(io.BytesIO(base64.b64decode(resp['images_b64'])))
    finally:
        httpd.shutdown()
        httpd.server_close()
    if imgs.shape[0] != 3 or imgs.ndim != 4 or not np.isfinite(imgs).all():
        raise RuntimeError(f'selftest: bad images {imgs.shape}')
    print(f'[serve] selftest OK — z_dim={meta["z_dim"]} '
          f'imgs={imgs.shape} via bucket ladder {meta["buckets"]} on {meta["platforms"]}')
    return imgs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--artifact', help='.pt2 file from scripts/torch_export_model.py')
    ap.add_argument('--host', default='127.0.0.1')
    ap.add_argument('--port', type=int, default=8000)
    ap.add_argument('--buckets', default='1,2,4,8,16,32',
                    help='batch bucket ladder (comma ints)')
    ap.add_argument('--max-n', type=int, default=1024, dest='max_n',
                    help='largest n a single request may ask for '
                         '(bounds per-request host memory)')
    ap.add_argument('--device', default='cuda',
                    help='where the program runs (cuda or cpu: the device it was exported '
                         'on); cuda without CUDA raises')
    ap.add_argument('--selftest', action='store_true',
                    help='synthetic end-to-end demo, then exit')
    args = ap.parse_args(argv)
    from latentaugment_tpu_torch.utils.util_general import resolve_device

    resolve_device(args.device)
    if args.selftest:
        return _selftest(args.device)
    if not args.artifact:
        ap.error('--artifact is required (or --selftest)')
    buckets = tuple(int(b) for b in args.buckets.split(','))
    service, httpd = serve(args.artifact, args.host, args.port, buckets,
                           max_request_n=args.max_n, device=args.device)
    print(f'[serve] {args.artifact}: z_dim={service.z_dim} '
          f'c_dim={service.c_dim} buckets={service.buckets} on '
          f'http://{args.host}:{httpd.server_address[1]}')
    httpd.serve_forever()


if __name__ == '__main__':
    main()
