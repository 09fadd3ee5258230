"""Latency and throughput of the port's HTTP service, on the card (the
port's counterpart of ``tools/bench_serve.py``).

Starts :mod:`paule_tpu_torch.serve` on a loopback port around a warm
``Paule(seed=9)`` and measures, over real HTTP round trips:

* /health            the control path's latency floor
* /synthesize        host C++ synthesis, T=201 and T=403 trajectories
* /embed             the embedder on the device, 100 mel frames
* /plan              a small planning budget (2 outer x 10 inner,
                     log_ii=5, no continue-learning)
* /synthesize x4     throughput with 4 concurrent clients

p50 and p95 per endpoint after 2 warm-up requests (1 for /plan); the
clock is the host's, around each request.

Run on the card::

    python -m paule_tpu_torch.tools.bench_serve [--n 30] [--plan-n 3]
        [--out FILE]

Prints one JSON line (with the card's name and power limit); without a
card it raises.
"""

import argparse
import concurrent.futures as cf
import http.client
import json
import statistics
import sys
import threading
import time

import numpy as np

from .. import serve, synth
from ..api import Paule
from ..ops.normalize import inv_normalize_cp
from . import timing


def _request(port, method, path, payload=None, timeout=600):
    """One request to the service on ``127.0.0.1:port`` (no proxy); ->
    the decoded JSON answer.  Raises on a status other than 200."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        body = None if payload is None else json.dumps(payload).encode()
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"{method} {path}: HTTP {resp.status} {data[:200]}")
    return json.loads(data)


def _lat(fn, n, warmup=2):
    for _ in range(warmup):
        fn()
    xs = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        xs.append((time.perf_counter() - t0) * 1e3)
    xs.sort()
    return {"p50_ms": statistics.median(xs),
            "p95_ms": xs[min(len(xs) - 1, int(0.95 * len(xs)))], "n": n}


def run(*, device="cuda", paule=None, n=30, plan_n=3):
    """The measurements above, ``n`` requests per metric and ``plan_n``
    for /plan.  ``paule``: the model to serve (default ``Paule(seed=9)``
    on ``device``, closed afterwards).  -> the result as a JSON-able
    dict."""
    device = timing.open_device(device)
    model = paule if paule is not None else Paule(seed=9, device=device)
    service = serve.PauleService(model)
    httpd = serve.make_server(service, "127.0.0.1", 0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        rng = np.random.default_rng(0)

        def cp_of(t):
            return np.clip(rng.normal(0, 0.05, (t, 30)).cumsum(0) * 0.2,
                           -1, 1)

        cp201, cp403 = cp_of(201), cp_of(403)
        mel = rng.normal(0, 1, (100, 60)).astype(np.float32)
        sig, _sr = synth.speak(inv_normalize_cp(cp201))

        def post(path, payload):
            return lambda: _request(port, "POST", path, payload)

        def synthesize(cp):
            return post("/synthesize", {"cp": serve.encode_array(cp),
                                        "normalized": True})

        m = {"health": _lat(lambda: _request(port, "GET", "/health"), n),
             "synthesize_T201": _lat(synthesize(cp201), n),
             "synthesize_T403": _lat(synthesize(cp403), n),
             "embed_F100": _lat(post("/embed",
                                     {"mel": serve.encode_array(mel)}), n)}
        plan_payload = {"signal": serve.encode_array(sig),
                        "sample_rate": 44100, "n_outer": 2, "n_inner": 10,
                        "log_ii": 5, "continue_learning": False}
        m["plan_2x10"] = _lat(post("/plan", plan_payload), plan_n,
                              warmup=1)

        # concurrent synthesis throughput: 4 client threads, n requests
        one = synthesize(cp201)
        one()
        t0 = time.perf_counter()
        with cf.ThreadPoolExecutor(4) as ex:
            for fut in [ex.submit(one) for _ in range(n)]:
                fut.result()
        dt = time.perf_counter() - t0
        m["synthesize_T201_concurrent4"] = {"req_per_s": n / dt, "n": n}
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
        if paule is None:
            model.close()
    return {"host": "loopback HTTP, ThreadingHTTPServer",
            **timing.labels(device), "metrics": m}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--n", type=int, default=30, help="requests per metric")
    ap.add_argument("--plan-n", type=int, default=3)
    args = ap.parse_args(argv)
    timing.emit(run(device="cuda", n=args.n, plan_n=args.plan_n), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
