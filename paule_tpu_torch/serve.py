"""HTTP service for planning and synthesis around a warm
:class:`paule_tpu_torch.api.Paule` (counterpart of ``paule_tpu/serve.py``).

* Planning requests take the model's lock one at a time (planning trains
  the models); synthesis and embedding requests run concurrently.
* Arrays travel as base64 little-endian float32 (or float64) with their
  shape, or as nested JSON lists.
* Start with ``python -m paule_tpu_torch.serve --port 8750 [--device
  cuda]`` or call :func:`serve`.

Endpoints
---------
GET  /health       -> {"status": "ok"|"warming"|"error", "backend": the
                       torch device type, "n_devices": CUDA devices,
                       "version": ...}
POST /synthesize   {"cp": <array (T,30)>, "normalized": true}
                   -> {"audio": <array>, "sample_rate": 44100}
POST /embed        {"mel": <array (F,60)>} -> {"semvec": <array (300,)>}
POST /plan         {"signal": <array>, "sample_rate": int, ...plan kwargs}
                   -> planned trajectory, losses, produced audio
POST /plan_batch   {"signals": [<array>, ...], "sample_rate": int,
                    "max_batch": int, ...plan kwargs}
                   -> {"results": [per-utterance planned cp/audio/losses]}

Every POST answers 503 while the model warms up or after it failed to
start.  A body above ``PauleService.MAX_REQUEST_BYTES`` gets 413 before it
is read; a planning request beyond ``PLAN_QUEUE_LIMIT`` waiting ones, or
whose wait for the lock exceeds ``PLAN_WAIT_TIMEOUT_S``, gets 429 with a
Retry-After header; a warmup still running after ``warmup_timeout``
seconds turns /health to "error".
"""

import base64
import contextlib
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from . import __version__
from . import checkpoint, synth
from .api import Paule
from .experiments import plan_corpus_batched
from .ops.normalize import inv_normalize_cp


class ServiceBusy(Exception):
    """The planning queue is full or the wait timed out (HTTP 429)."""


def encode_array(arr):
    arr = np.asarray(arr, dtype=np.float32)
    return {"b64": base64.b64encode(arr.astype("<f4").tobytes()).decode(),
            "shape": list(arr.shape), "dtype": "float32"}


_DTYPES = {"float32": "<f4", "float64": "<f8"}


def decode_array(obj):
    if isinstance(obj, dict) and "b64" in obj:
        tag = obj.get("dtype", "float32")
        if tag not in _DTYPES:
            raise ValueError(
                f"unsupported array dtype {tag!r}; use one of "
                f"{sorted(_DTYPES)}")
        arr = np.frombuffer(base64.b64decode(obj["b64"]),
                            dtype=_DTYPES[tag])
        return arr.reshape(obj["shape"]).astype(np.float64)
    return np.asarray(obj, dtype=np.float64)


class PauleService:
    """The request handlers, apart from the HTTP plumbing.  Without
    ``paule_model`` the model is built as ``Paule(**paule_kwargs)``: on the
    card unless ``device="cpu"`` is passed, raising without CUDA."""

    #: request bodies above this are rejected with 413 before being read
    MAX_REQUEST_BYTES = 64 << 20
    #: planning requests allowed to wait for the lock beside the running
    #: one; beyond this the service answers 429 at once
    PLAN_QUEUE_LIMIT = 4
    #: seconds a queued planning request waits for the lock before 429
    PLAN_WAIT_TIMEOUT_S = 300.0

    def __init__(self, paule_model=None, defer_model=False,
                 max_request_bytes=None, plan_queue_limit=None,
                 plan_wait_timeout_s=None, **paule_kwargs):
        self._paule_kwargs = paule_kwargs
        self._plan_lock = threading.Lock()
        self._waiters_lock = threading.Lock()
        self._plan_waiters = 0
        if max_request_bytes is not None:
            self.MAX_REQUEST_BYTES = int(max_request_bytes)
        if plan_queue_limit is not None:
            self.PLAN_QUEUE_LIMIT = int(plan_queue_limit)
        if plan_wait_timeout_s is not None:
            self.PLAN_WAIT_TIMEOUT_S = float(plan_wait_timeout_s)
        #: clear while the model is built and warmed up: /health says
        #: "warming" and the compute endpoints answer 503
        self.ready = threading.Event()
        #: the exception of a failed build or warmup: /health says "error"
        self.startup_error = None
        self.model = paule_model
        if paule_model is None and not defer_model:
            self._build_model()
        if self.model is not None:
            self.ready.set()

    def _build_model(self):
        self.model = Paule(**self._paule_kwargs)

    @contextlib.contextmanager
    def _plan_slot(self):
        """Bounded admission to the planning lock: at most
        ``PLAN_QUEUE_LIMIT`` requests wait, each at most
        ``PLAN_WAIT_TIMEOUT_S``; others get :class:`ServiceBusy`."""
        with self._waiters_lock:
            if self._plan_waiters >= self.PLAN_QUEUE_LIMIT:
                raise ServiceBusy(
                    f"plan queue full ({self.PLAN_QUEUE_LIMIT} waiting); "
                    "retry later")
            self._plan_waiters += 1
        try:
            if not self._plan_lock.acquire(
                    timeout=self.PLAN_WAIT_TIMEOUT_S):
                raise ServiceBusy(
                    f"timed out after {self.PLAN_WAIT_TIMEOUT_S:.0f}s "
                    "waiting for the planning lock; retry later")
        finally:
            with self._waiters_lock:
                self._plan_waiters -= 1
        try:
            yield
        finally:
            self._plan_lock.release()

    def health(self):
        if self.startup_error is not None:
            status = "error"
        elif self.ready.is_set():
            status = "ok"
        else:
            status = "warming"
        device = (self.model.device.type if self.model is not None
                  else self._paule_kwargs.get("device") or "cuda")
        out = {"status": status, "backend": str(device),
               "n_devices": torch.cuda.device_count(),
               "version": __version__}
        if self.startup_error is not None:
            out["error"] = (f"{type(self.startup_error).__name__}: "
                            f"{self.startup_error}")
        return out

    def synthesize(self, payload):
        cp = decode_array(payload["cp"])
        if payload.get("normalized", True):
            cp = inv_normalize_cp(cp)
        sig, sr = self.model.synth_pool.speak(cp)
        return {"audio": encode_array(sig), "sample_rate": sr}

    def embed(self, payload):
        mel = self.model._tensor(decode_array(payload["mel"])[None])
        semvec = self.model._embed(mel)
        return {"semvec": encode_array(semvec[0].cpu().numpy())}

    def plan_batch(self, payload):
        """Plan several utterances together: {"signals": [<array>, ...],
        "sample_rate": int, ...plan kwargs}, bucketed by their mel length
        (:func:`~paule_tpu_torch.experiments.plan_corpus_batched`); the
        results come back in input order."""
        payload = dict(payload)
        signals = [decode_array(s) for s in payload.pop("signals")]
        sr = int(payload.pop("sample_rate", 44100))
        max_batch = int(payload.pop("max_batch", 8))
        allowed = {"objective", "n_outer", "n_inner", "continue_learning",
                   "batch_size", "n_epochs", "learning_rate_planning"}
        unknown = set(payload) - allowed
        if unknown:
            raise ValueError(
                f"unknown plan_batch parameters: {sorted(unknown)}; "
                f"allowed: {sorted(allowed)}")
        with self._plan_slot():
            per_utt = plan_corpus_batched(
                self.model, [(s, sr) for s in signals], max_batch=max_batch,
                plan_kwargs=payload, verbose=False)
        return {"results": [
            {"planned_cp": encode_array(r["planned_cp"]),
             "audio": encode_array(r["prod_sig"]), "sample_rate": 44100,
             "prod_loss_curve": [float(x) for x in r["prod_loss_curve"]]}
            for r in per_utt]}

    def plan(self, payload):
        payload = dict(payload)
        sig = decode_array(payload.pop("signal"))
        sr = int(payload.pop("sample_rate", 44100))
        allowed = {
            "objective", "initialize_from", "n_outer", "n_inner", "log_ii",
            "n_batches", "batch_size", "n_epochs", "continue_learning",
            "learning_rate_planning", "learning_rate_learning",
            "log_semantics", "seed"}
        unknown = set(payload) - allowed
        if unknown:
            raise ValueError(
                f"unknown plan parameters: {sorted(unknown)}; "
                f"allowed: {sorted(allowed)}")
        with self._plan_slot():
            results = self.model.plan_resynth(
                target_acoustic=(sig, sr), verbose=False, **payload)
        return {
            "planned_cp": encode_array(results.planned_cp),
            "audio": encode_array(results.prod_sig),
            "sample_rate": results.prod_sr,
            "prod_loss_steps": [float(x) for x in results.prod_loss_steps],
            "planned_loss_steps": [float(x)
                                   for x in results.planned_loss_steps]}


def make_server(service, host="127.0.0.1", port=8750):
    """A threaded HTTP server of ``service`` on ``(host, port)`` (port 0:
    any free port, ``server.server_address`` names it)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code, obj, headers=None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for name, value in (headers or {}).items():
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, service.health())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                if service.startup_error is not None:
                    self._send(503, {"error": "startup failed: "
                               f"{type(service.startup_error).__name__}: "
                               f"{service.startup_error}"})
                    return
                if not service.ready.is_set():
                    self._send(503, {"error": "warming up; retry shortly"})
                    return
                n = int(self.headers.get("Content-Length", 0))
                if n > service.MAX_REQUEST_BYTES:
                    self._send(413, {
                        "error": f"request body {n} bytes exceeds the "
                                 f"{service.MAX_REQUEST_BYTES}-byte limit"})
                    # drain (up to 256 MB) what the client still sends, so
                    # that closing the socket does not reset the connection
                    # before it reads the 413
                    self.wfile.flush()
                    remaining = min(n, 1 << 28)
                    while remaining > 0:
                        chunk = self.rfile.read(min(remaining, 1 << 20))
                        if not chunk:
                            break
                        remaining -= len(chunk)
                    return
                payload = json.loads(self.rfile.read(n) or b"{}")
                routes = {"/synthesize": service.synthesize,
                          "/embed": service.embed, "/plan": service.plan,
                          "/plan_batch": service.plan_batch}
                if self.path in routes:
                    self._send(200, routes[self.path](payload))
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})
            except ServiceBusy as exc:
                self._send(429, {"error": str(exc)},
                           headers={"Retry-After": "30"})
            except (KeyError, ValueError, TypeError) as exc:
                self._send(400, {"error": f"{type(exc).__name__}: {exc}"})
            except Exception as exc:  # noqa: BLE001  (the client is told)
                self._send(500, {"error": f"{type(exc).__name__}: {exc}"})

    return ThreadingHTTPServer((host, port), Handler)


class WarmupTimeout(RuntimeError):
    """Warmup was still running at the watchdog's deadline."""


def start_warmup(service, lengths, warmup_timeout=None):
    """Build the model if deferred and run :func:`_warmup` in a daemon
    thread.  With ``warmup_timeout`` (seconds), a watchdog thread turns
    /health to "error" if warmup is still running at the deadline; a late
    completion clears that error and serves."""
    service.ready.clear()
    # serialises the completion and the deadline, so that a warmup that
    # completes while the watchdog fires cannot be left reporting "error"
    guard = threading.Lock()

    def _run_warmup():
        try:
            if service.model is None:
                service._build_model()
            _warmup(service.model, lengths)
            with guard:
                if isinstance(service.startup_error, WarmupTimeout):
                    service.startup_error = None
                service.ready.set()
            print("paule_tpu_torch warmup complete")
        except Exception as exc:  # noqa: BLE001  (/health reports it)
            service.startup_error = exc
            print(f"paule_tpu_torch startup FAILED: "
                  f"{type(exc).__name__}: {exc}")

    threading.Thread(target=_run_warmup, daemon=True).start()
    if warmup_timeout:
        def _watchdog():
            if not service.ready.wait(warmup_timeout):
                with guard:
                    if (not service.ready.is_set()
                            and service.startup_error is None):
                        service.startup_error = WarmupTimeout(
                            f"warmup still running after "
                            f"{warmup_timeout:.0f}s; compute endpoints stay "
                            "503 until it completes")

        threading.Thread(target=_watchdog, daemon=True).start()


def serve(host="127.0.0.1", port=8750, *, paule_model=None, warmup=True,
          warmup_timeout=1800.0, **paule_kwargs):
    """Serve until interrupted.  ``warmup``: ``True`` runs a short plan of
    40 cp frames in the background before serving compute requests (the
    first call builds the LSTM kernels), an iterable of cp-frame lengths a
    plan at each, ``False`` none.  The port binds at once and /health says
    "warming" until the warmup ends."""
    if warmup is True:
        lengths = (40,)
    elif not warmup:
        lengths = ()
    else:
        lengths = tuple(int(x) for x in warmup) or (40,)
    service = PauleService(paule_model, defer_model=bool(lengths),
                           **paule_kwargs)
    server = make_server(service, host, port)
    if lengths:
        start_warmup(service, lengths, warmup_timeout)
    print(f"paule_tpu_torch serving on http://{host}:{port}")
    server.serve_forever()


def _warmup(model, cp_lengths=(40,)):
    """Short continue-learning plans at each of ``cp_lengths`` cp frames,
    so that the kernels are built and the first requests do not pay for
    it.  They train the models on noise, so the model's state (weights,
    Adam moments, replay buffer, generators) is taken before and restored
    after: the model served is the one loaded."""
    state = checkpoint.paule_state(model)
    py_rng_state = model._py_rng.getstate()
    try:
        rng = np.random.default_rng(0)
        for n_cp in cp_lengths:
            n_cp = max(4, int(n_cp) + (int(n_cp) % 2))  # even length
            cp = np.clip(rng.normal(0, 0.1, (n_cp, 30)).cumsum(0) * 0.1,
                         -1, 1)
            sig, sr = synth.speak(inv_normalize_cp(cp))
            model.plan_resynth(
                target_acoustic=(sig, sr), objective="acoustic",
                initialize_from="acoustic", n_outer=1, n_inner=2, log_ii=1,
                n_batches=1, batch_size=2, n_epochs=1,
                continue_learning=True, verbose=False)
    finally:
        checkpoint.restore_paule_state(model, state)
        model._py_rng.setstate(py_rng_state)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description="paule_tpu_torch HTTP service")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8750)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default: cuda)")
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--warmup-lengths", default=None,
                    help="comma-separated cp-frame lengths to warm up "
                         "(2 x the mel frames of expected requests), e.g. "
                         "'40,200,400'")
    ap.add_argument("--warmup-timeout", type=float, default=1800.0,
                    help="seconds before a still-running warmup turns "
                         "/health to 'error' (0 disables)")
    ap.add_argument("--pretrained-dir", default=None)
    args = ap.parse_args(argv)
    if args.no_warmup:
        warmup = False
    elif args.warmup_lengths:
        warmup = [int(x) for x in args.warmup_lengths.split(",") if x]
    else:
        warmup = True
    serve(args.host, args.port, warmup=warmup,
          warmup_timeout=args.warmup_timeout, device=args.device,
          pretrained_dir=args.pretrained_dir)


if __name__ == "__main__":
    main()
