"""HTTP serving of a trained run (counterpart of ``tools/serve.py``)::

    python -m craniofacialsd_vae_tpu_torch.serve --id=RUN [--output_path=.]
        [--run_dir DIR] [--host 127.0.0.1] [--port 8008] [--max_batch 16]
        [--healthy_class n] [--no_warmup] [--warm_fit] [--device cuda|cpu]
        [--data_parallel]

Serves ``outputs/<id>/`` (a run dir of either package) on the card
unless ``--device cpu``; ``--data_parallel`` replicates the model on
every visible card and splits each request's bucket over them
(``max_batch`` must be a multiple of the card count). An ensemble dir
(one with an ``ensemble.json``, from either package's ensemble trainer)
is served by ``EnsembleService``: ``/diagnose`` answers the members'
consensus, ``/healthz`` the summed stats with ``n_members``, and every
single-model endpoint 400 with a pointer to the member dirs.

Endpoints (JSON in and out; vertices may also be posted as a raw ``.npy``
body with ``Content-Type: application/octet-stream``):

    GET  /healthz       → {"ok": true, ...service stats}
    POST /encode        {"vertices": [N, 3] | [B, N, 3]} → {"latent"}
    POST /diagnose      same (+ "model": qda|lda|svm|mlp, "n_samples",
                        "seed") → {"reports": [...]}
    POST /saliency      same (+ "model", "include_vertex_saliency")
                        → {"reports": [...]}
    POST /reconstruct   same → {vertices, vertex_errors_mm, mean_error_mm,
                        latent}
    POST /decode        {"latent": [Z] | [B, Z]} → {"vertices"}
    POST /fit           {"vertices": [M, 3] (an unregistered scan),
                        "landmarks": [K, 3], optional lr / iterations /
                        n_restarts / seed / model} → {z, vertices,
                        chamfer_mm2, landmark_mse_mm2, aligned_scan,
                        diagnosis}
    POST /plan          {"vertices": [N, 3] | "latent": [Z], optional
                        n_p_to_3std / n_linspace / model /
                        decode_key_meshes / include_paths} → the plan

A client error answers 400 with {"error"}, an unknown path 404.
"""

from __future__ import annotations

import argparse
import io
import json
import os
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

__all__ = ["make_handler", "make_server", "main"]


def _json_default(o):
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.floating, np.integer)):
        return o.item()
    raise TypeError(f"not serializable: {type(o)}")


def make_handler(service):
    """The request handler class over ``service`` (a
    ``DiagnosisService`` or an ``EnsembleService``)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet; stats via /healthz
            pass

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload, default=_json_default).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _read_body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n)
            ctype = self.headers.get("Content-Type", "application/json")
            if ctype.startswith("application/octet-stream"):
                arr = np.load(io.BytesIO(raw), allow_pickle=False)
                return {"vertices": arr}
            body = json.loads(raw or b"{}")
            if not isinstance(body, dict):
                raise ValueError("the request body must be a JSON object")
            return body

        def do_GET(self):
            if self.path == "/healthz":
                stats = service.stats()
                stats["ok"] = True
                self._reply(200, stats)
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def _answer(self, body: dict):
            path = self.path
            if path == "/encode":
                return {"latent": service.encode(
                    np.asarray(body["vertices"], np.float32))}
            if path == "/diagnose":
                return {"reports": service.diagnose(
                    np.asarray(body["vertices"], np.float32),
                    model=body.get("model", "qda"),
                    n_samples=int(body.get("n_samples", 0)),
                    seed=int(body.get("seed", 0)))}
            if path == "/saliency":
                return {"reports": service.saliency(
                    np.asarray(body["vertices"], np.float32),
                    include_vertex_saliency=bool(
                        body.get("include_vertex_saliency", True)),
                    model=body.get("model", "qda"))}
            if path == "/reconstruct":
                return service.reconstruct(
                    np.asarray(body["vertices"], np.float32))
            if path == "/decode":
                return {"vertices": service.decode(
                    np.asarray(body["latent"], np.float32))}
            if path == "/fit":
                return service.fit(
                    np.asarray(body["vertices"], np.float32),
                    np.asarray(body["landmarks"], np.float32),
                    lr=float(body.get("lr", 5e-3)),
                    iterations=int(body.get("iterations", 250)),
                    n_restarts=int(body.get("n_restarts", 16)),
                    seed=int(body.get("seed", 0)),
                    model=body.get("model", "qda"))
            if path == "/plan":
                return service.plan(
                    vertices=(np.asarray(body["vertices"], np.float32)
                              if "vertices" in body else None),
                    latent=(np.asarray(body["latent"], np.float32)
                            if "latent" in body else None),
                    n_p_to_3std=int(body.get("n_p_to_3std", 8)),
                    n_linspace=int(body.get("n_linspace", 5000)),
                    model=body.get("model", "qda"),
                    decode_key_meshes=bool(
                        body.get("decode_key_meshes", True)),
                    include_paths=bool(body.get("include_paths", False)))
            return None

        def do_POST(self):
            try:
                out = self._answer(self._read_body())
            except Exception as e:  # a boundary: report to the client
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                return
            if out is None:
                self._reply(404, {"error": f"unknown path {self.path}"})
            else:
                self._reply(200, out)

    return Handler


def make_server(service, host: str = "127.0.0.1",
                port: int = 8008) -> ThreadingHTTPServer:
    """A threading HTTP server over ``service`` (port 0: any free
    port; read it from ``server.server_port``)."""
    return ThreadingHTTPServer((host, port), make_handler(service))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--id", type=str, default=None)
    parser.add_argument("--output_path", type=str, default=".")
    parser.add_argument("--run_dir", type=str, default=None,
                        help="explicit run dir (overrides --id)")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8008)
    parser.add_argument("--max_batch", type=int, default=16)
    parser.add_argument("--healthy_class", type=str, default="n")
    parser.add_argument("--no_warmup", action="store_true")
    parser.add_argument("--warm_fit", action="store_true",
                        help="also run one fit at startup (a template-"
                             "derived scan of 32,768 points)")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--data_parallel", action="store_true",
                        help="replicate the model on every visible card and "
                             "split each request's bucket over them")
    args = parser.parse_args(argv)
    if not args.run_dir and not args.id:
        parser.error("--id or --run_dir required")
    run_dir = args.run_dir or os.path.join(args.output_path, "outputs",
                                           args.id)

    from .serving import DiagnosisService, EnsembleService

    kwargs = dict(healthy_class=args.healthy_class,
                  max_batch=args.max_batch, warm=not args.no_warmup,
                  device=args.device, data_parallel=args.data_parallel)
    if os.path.exists(os.path.join(run_dir, "ensemble.json")):
        service = EnsembleService.from_ensemble_dir(run_dir, **kwargs)
        print(f"ensemble of {service.n_members} members", flush=True)
        if args.warm_fit:
            print("--warm_fit skipped: fit is a single-model request — "
                  "serve a member run dir for the fit intake", flush=True)
    else:
        service = DiagnosisService.from_run_dir(run_dir, **kwargs)
        if args.warm_fit:
            service.warmup_fit()
    server = make_server(service, args.host, args.port)
    print(f"serving {run_dir} on http://{args.host}:{server.server_port} "
          f"({service.device}, {service.n_devices} device(s), buckets "
          f"{service.buckets})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
