"""HTTP forecasting server for the port (after the root serve.py).

    python -m imm_tsf_torch.serve --load <experiment_dir> [--port 8000] \
        [--host 127.0.0.1] [--max_batch 32] [--max_wait_ms 5] [--device cuda]
    python -m imm_tsf_torch.serve --artifact <artifact_dir> [--port 8000] ...

<experiment_dir> is the port's experiment directory (`config.json` and
`best/weights.pt`, see training/checkpoint.py). `--artifact` serves an
exported artifact instead (python -m imm_tsf_torch.export_model;
export.ExportedForecaster): no model code or weights are restored, and
each request is one synchronous dispatch. Serves:

  GET  /healthz      -> {"ok": true, "model": ..., "dataset": ..., "epoch": N}
  GET  /metrics      -> service counters, dispatch latency, and the CUDA
                        graphs captured (graphs_captured, capture_s_total)
  POST /v1/forecast  -> {"predictions": [{"tp": [...], "prediction": [[...]]}]}
       body: {"instances": [<instance schema — see imm_tsf_torch/serving.py>]}

Concurrent requests are micro-batched into single device dispatches;
on cuda each dispatch replays its input shape's CUDA graph.
The server runs on cuda unless --device cpu is passed. An experiment
trained on raw text (use_text_embeddings=false) takes {"tau", "text"}
notes: the server loads its frozen GPT-2 on the same device (from
IMM_TSF_LLM_DIR/GPT2 when that holds a checkpoint, else random from a
seed with the hash tokenizer) and caches each string's embedding.
"""

from __future__ import annotations

import argparse
import json
import sys
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m imm_tsf_torch.serve",
                                 allow_abbrev=False)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--load", help="experiment directory (config.json + best/weights.pt)")
    src.add_argument("--artifact", help="an exported artifact directory "
                                        "(python -m imm_tsf_torch.export_model)")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--max_batch", type=int, default=32)
    ap.add_argument("--max_wait_ms", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def make_handler(svc):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet default stderr spam
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"ok": True, "model": svc.cfg.model,
                                 "dataset": svc.cfg.dataset,
                                 "enable_text": svc.cfg.enable_text,
                                 "device": str(svc.device),
                                 "epoch": int(svc.step)})
            elif self.path == "/metrics":
                self._send(200, svc.metrics())
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/v1/forecast":
                self._send(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                instances = req["instances"]
                if not isinstance(instances, list) or not instances:
                    raise ValueError("instances must be a non-empty list")
            except (ValueError, KeyError, TypeError) as e:
                self._send(400, {"error": f"bad request: {e}"})
                return
            try:
                preds = svc.forecast(instances)
            except ValueError as e:  # per-request validation errors
                self._send(400, {"error": str(e)})
                return
            except Exception as e:
                self._send(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._send(200, {"predictions": preds})

    return Handler


def build_service(args):
    """The live ForecastService of --load, or the ExportedForecaster of
    --artifact (the root serve.py:36-54)."""
    if args.artifact is not None:
        from .export import ExportedForecaster

        return ExportedForecaster(args.artifact, device=args.device)
    from .serving import ForecastService

    return ForecastService(args.load, max_batch=args.max_batch,
                           max_wait_ms=args.max_wait_ms, device=args.device)


def main(argv=None):
    args = parse_args(list(sys.argv[1:] if argv is None else argv))
    svc = build_service(args)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(svc))
    print(f"# serving {svc.cfg.model} on {svc.cfg.dataset} at "
          f"http://{args.host}:{args.port} on {svc.device} "
          f"(max_batch={svc.max_batch})", file=sys.stderr)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()
        svc.close()


if __name__ == "__main__":
    main()
