"""The port's HTTP service (``paule_tpu_torch.serve``) on an ephemeral port
around a CPU ``Paule`` (float64): /health, /synthesize, /embed, /plan (as
a direct ``plan_resynth`` with the same seed), /plan_batch, the 400, 413
and 429 answers, the warmup that restores the model's state bit for bit,
and the card as the default device."""

import copy
import http.client
import json
import threading

import numpy as np
import pytest
import torch

from paule_tpu_torch import checkpoint as CK
from paule_tpu_torch import serve as S
from paule_tpu_torch import synth
from paule_tpu_torch.api import Paule
from paule_tpu_torch.ops.normalize import inv_normalize_cp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

F64 = {"device": "cpu", "dtype": torch.float64}
TINY = dict(n_outer=1, n_inner=2, continue_learning=False)


def _signal(n_cp=24, seed=0):
    rng = np.random.default_rng(seed)
    cp = np.clip(rng.normal(0, 0.1, (n_cp, 30)).cumsum(0) * 0.1, -1, 1)
    return synth.speak(inv_normalize_cp(cp))


@pytest.fixture
def served():
    """-> ``start(**service_kwargs)``: a service around a fresh CPU Paule
    (seed 7) and a server on ``127.0.0.1:0``, closed after the test;
    ``start`` returns ``(service, request)``, ``request(method, path,
    body=None, headers=None) -> (status, headers, json)``."""
    opened = []

    def start(**service_kwargs):
        paule = Paule(seed=7, **F64)
        service = S.PauleService(paule, **service_kwargs)
        server = S.make_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        opened.append((server, paule))
        port = server.server_address[1]

        def request(method, path, body=None, headers=None):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
            data = body if isinstance(body, bytes) or body is None else (
                json.dumps(body).encode())
            conn.request(method, path, body=data, headers=headers or {})
            resp = conn.getresponse()
            out = (resp.status, dict(resp.getheaders()),
                   json.loads(resp.read() or b"{}"))
            conn.close()
            return out

        return service, request

    yield start
    for server, paule in opened:
        server.shutdown()
        server.server_close()
        paule.close()


def test_health_synthesize_and_embed(served):
    service, request = served()
    status, _h, health = request("GET", "/health")
    assert status == 200
    assert health["status"] == "ok" and health["backend"] == "cpu"
    assert health["version"] == S.__version__
    assert health["n_devices"] == torch.cuda.device_count()
    cp = np.zeros((20, 30))
    status, _h, out = request("POST", "/synthesize", {
        "cp": S.encode_array(cp), "normalized": True})
    assert status == 200 and out["sample_rate"] == 44100
    audio = S.decode_array(out["audio"])
    np.testing.assert_allclose(audio, synth.speak(inv_normalize_cp(cp))[0],
                               rtol=0, atol=1e-7)
    mel = np.random.default_rng(1).normal(0, 0.3, (10, 60))
    status, _h, out = request("POST", "/embed", {"mel": mel.tolist()})
    assert status == 200
    with torch.no_grad():
        want = service.model.embedder(torch.tensor(mel[None]))[0].numpy()
    np.testing.assert_allclose(S.decode_array(out["semvec"]), want, rtol=0,
                               atol=1e-6)


def test_plan_equals_a_direct_plan(served):
    """/plan with a seed plans as ``plan_resynth`` of the same signal
    (after its float32 transport) on an instance of the same seed."""
    _service, request = served()
    sig, sr = _signal()
    body = {"signal": S.encode_array(sig), "sample_rate": sr, "seed": 11,
            "objective": "acoustic_semvec", **TINY}
    status, _h, out = request("POST", "/plan", body)
    assert status == 200, out
    direct = Paule(seed=7, **F64)
    try:
        ref = direct.plan_resynth(
            target_acoustic=(S.decode_array(body["signal"]), sr), seed=11,
            objective="acoustic_semvec", verbose=False, **TINY)
    finally:
        direct.close()
    np.testing.assert_allclose(S.decode_array(out["planned_cp"]),
                               ref.planned_cp, rtol=0, atol=1e-7)
    assert out["planned_loss_steps"] == ref.planned_loss_steps
    assert out["prod_loss_steps"] == ref.prod_loss_steps
    assert S.decode_array(out["audio"]).shape == ref.prod_sig.shape


def test_plan_batch(served):
    _service, request = served()
    sigs = [_signal(24, seed) for seed in (1, 2, 3)]
    status, _h, out = request("POST", "/plan_batch", {
        "signals": [S.encode_array(s) for s, _sr in sigs],
        "sample_rate": 44100, "max_batch": 2, "n_outer": 2, "n_inner": 2,
        "continue_learning": False})
    assert status == 200, out
    assert len(out["results"]) == 3
    for res in out["results"]:
        assert S.decode_array(res["planned_cp"]).shape == (24, 30)
        assert S.decode_array(res["audio"]).shape == (23 * 110,)
        assert len(res["prod_loss_curve"]) == 2
        assert np.isfinite(res["prod_loss_curve"]).all()


def test_bad_requests(served):
    """An unknown planning key is 400, a body over the limit 413, a full
    planning queue 429 with a Retry-After header."""
    _service, request = served(max_request_bytes=1000, plan_queue_limit=0)
    sig, sr = _signal()
    status, _h, out = request("POST", "/plan", {
        "signal": [0.0] * 10, "sample_rate": sr, "plot": True})
    assert status == 400 and "plot" in out["error"]
    status, _h, out = request("POST", "/plan_batch", {
        "signals": [[0.0] * 10], "log_ii": 1})
    assert status == 400 and "log_ii" in out["error"]
    status, _h, out = request("POST", "/plan",
                              {"signal": S.encode_array(sig)})
    assert status == 413
    status, headers, _out = request("POST", "/plan", {
        "signal": [0.0] * 10, "sample_rate": sr, **TINY})
    assert status == 429 and headers["Retry-After"] == "30"
    assert request("POST", "/nowhere", {})[0] == 404


def test_warmup_restores_the_state_bit_for_bit():
    """The warmup's continue-learning plans train the models; afterwards
    the parameters, the Adam states, the replay buffer and the random
    generators are what they were (``checkpoint.paule_state`` owns its
    tensors on the CPU)."""
    paule = Paule(seed=7, continue_data={"cp_norm": []}, **F64)
    try:
        sig, sr = _signal(40)
        paule.plan_resynth(target_acoustic=(sig, sr), continue_learning=True,
                           n_outer=1, n_inner=2, n_batches=1, batch_size=2,
                           n_epochs=1, verbose=False)
        before = copy.deepcopy(CK.paule_state(paule))
        py_rng = paule._py_rng.getstate()
        steps = paule.pred_trainer.steps
        S._warmup(paule, (40, 24))
        assert paule.pred_trainer.steps == steps + 2, "warmup did not train"
        after = CK.paule_state(paule)
    finally:
        paule.close()
    assert paule._py_rng.getstate() == py_rng
    for key, value in before.items():
        if torch.is_tensor(value) or isinstance(value, dict):
            assert _equal(after[key], value), key


def _equal(a, b):
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_service_defaults_to_the_card(monkeypatch):
    """Without a model or a device, the service builds ``Paule()`` on the
    card, which raises without CUDA; a deferred one reports the card in
    /health until then."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        S.PauleService()
    deferred = S.PauleService(defer_model=True)
    health = deferred.health()
    assert health["status"] == "warming" and health["backend"] == "cuda"
