"""The port's HTTP front end (aule_tpu_torch/serving/http_api.py) against
the JAX package's (tests/test_http_api.py's seven cases, with a stdlib
client against a live server over the port's engine on the CPU).

Blocking and streamed tokens (and logprobs, within 1e-5) equal JAX's
engine on the same weights (carried across by `load_jax_params`) driven
directly; the endpoints, JSON fields and status codes are JAX's.  Two
more cases pin faults of the reference that the port does not copy: a
request that arrives as the engine dies gets an answer, never a hang, and
a /v1/cancel posted while the engine runs is served before the request
finishes.
"""

import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from aule_tpu.models import llama as jllama
from aule_tpu.serving.engine import ServingEngine as JaxEngine
from aule_tpu_torch.models import llama as tllama
from aule_tpu_torch.serving import ServingHTTPServer
from aule_tpu_torch.serving.engine import ServingEngine
from aule_tpu_torch.utils.testing import cap_cpu_threads

cap_cpu_threads()

JCFG = jllama.LlamaConfig.tiny()
TCFG = tllama.LlamaConfig.tiny()
KW = dict(max_batch=2, page_size=16, num_pages=64, max_pages_per_seq=8,
          max_seq_len=256)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(JCFG, jax.random.key(0))
    return jp, tllama.load_jax_params(jax.tree.map(np.asarray, jp),
                                      device="cpu")


@pytest.fixture(scope="module")
def jax_solo(params):
    """JAX's engine driven directly, one request at a time (one engine,
    so its compiled steps are reused): (tokens, logprobs)."""
    eng = JaxEngine(params[0], JCFG, **KW)

    def run(prompt, n, logprobs=False):
        eng.submit(prompt, max_new_tokens=n, logprobs=logprobs)
        r = eng.run()[0]
        return r.output, (r.logprobs if logprobs else None)

    return run


def make_engine(params):
    return ServingEngine(params[1], TCFG, device="cpu", **KW)


def url(srv, path):
    return f"http://127.0.0.1:{srv.port}{path}"


def post(srv, path, obj, timeout=120):
    req = urllib.request.Request(
        url(srv, path), data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 256, size=n).astype(
        np.int32)


def test_completions_and_health(params, jax_solo):
    prompt = _prompt(0, 7)
    want, want_lp = jax_solo(prompt, 6, logprobs=True)
    with ServingHTTPServer(make_engine(params)) as srv:
        health = json.loads(urllib.request.urlopen(url(srv, "/health"),
                                                   timeout=60).read())
        assert health["status"] == "ok"
        assert health["free_pages"] == 63 and health["running"] == 0
        out = post(srv, "/v1/completions",
                   {"prompt": prompt.tolist(), "max_tokens": 6,
                    "logprobs": True})
        assert out["tokens"] == want
        np.testing.assert_allclose(out["logprobs"], want_lp, atol=1e-5)
        assert not out["cancelled"] and out["id"] == 0


def test_streaming_ndjson(params, jax_solo):
    prompt = _prompt(1, 6)
    want, _ = jax_solo(prompt, 5)
    with ServingHTTPServer(make_engine(params)) as srv:
        req = urllib.request.Request(
            url(srv, "/v1/completions"),
            data=json.dumps({"prompt": prompt.tolist(), "max_tokens": 5,
                             "stream": True}).encode(),
            headers={"Content-Type": "application/json"})
        lines = []
        with urllib.request.urlopen(req, timeout=120) as resp:
            assert resp.headers["Content-Type"] == "application/x-ndjson"
            for raw in resp:
                if raw.strip():
                    lines.append(json.loads(raw))
    toks = [ln["token"] for ln in lines if "token" in ln]
    assert toks == want
    assert lines[-1]["done"] and not lines[-1]["cancelled"]


def test_concurrent_requests_batch(params, jax_solo):
    """Two blocking requests in flight share the engine batch; each gets
    its own solo-run tokens back (JAX's solo runs)."""
    prompts = [_prompt(2, 5), _prompt(3, 9)]
    wants = [jax_solo(p, 4)[0] for p in prompts]
    with ServingHTTPServer(make_engine(params)) as srv:
        outs = [None, None]

        def go(i):
            outs[i] = post(srv, "/v1/completions",
                           {"prompt": prompts[i].tolist(), "max_tokens": 4})

        ts = [threading.Thread(target=go, args=(i,)) for i in (0, 1)]
        [t.start() for t in ts]
        [t.join(timeout=300) for t in ts]
        stats = srv.engine.stats()
    assert [o["tokens"] for o in outs] == wants
    assert stats["tokens_generated"] == 8


def test_cancel_endpoint(params):
    with ServingHTTPServer(make_engine(params)) as srv:
        out = post(srv, "/v1/cancel", {"id": 12345})
        assert out["cancelled"] is False
        # bad request surfaces as 400, not a hung connection
        req = urllib.request.Request(
            url(srv, "/v1/completions"),
            data=json.dumps({"max_tokens": 4}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url(srv, "/nowhere"), timeout=60)
        assert ei.value.code == 404


def _completion_request(srv, prompt, n=4):
    return urllib.request.Request(
        url(srv, "/v1/completions"),
        data=json.dumps({"prompt": prompt.tolist(),
                         "max_tokens": n}).encode(),
        headers={"Content-Type": "application/json"})


def test_driver_death_fails_loudly(params):
    """An exception inside engine.step() must not leave clients hanging:
    in-flight requests get a 500, new ones a 503, /health flips to 500
    with the error."""
    eng = make_engine(params)

    def bad_step():
        raise RuntimeError("injected device failure")

    with ServingHTTPServer(eng) as srv:
        eng.step = bad_step
        req = _completion_request(srv, _prompt(4, 5))
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=120)
        assert ei.value.code == 500
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 503
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url(srv, "/health"), timeout=60)
        assert ei.value.code == 500
        assert "injected" in json.loads(ei.value.read())["error"]


class _LateLock:
    """The server's lock, except that a handler thread acquires it only
    once the engine has died: a request that passed the handler's first
    error check as the driver fails (the JAX server then registers it
    after the waiters were released, and it waits for ever)."""

    def __init__(self, srv):
        self.srv, self.lock = srv, threading.Lock()

    def acquire(self):
        if threading.current_thread() is not self.srv._drive_thread:
            deadline = time.monotonic() + 60
            while self.srv.error is None and time.monotonic() < deadline:
                time.sleep(0.01)
        self.lock.acquire()

    def release(self):
        self.lock.release()

    def __enter__(self):
        self.acquire()

    def __exit__(self, *exc):
        self.release()


def test_request_racing_the_driver_death_is_answered(params):
    """A fault of the reference the port does not copy (ROADMAP queue 3):
    the error is recorded and the waiters released under the engine lock,
    and a handler reads it there, so a request that raced the failure is
    answered (503) instead of hanging."""
    eng = make_engine(params)

    def bad_step():
        raise RuntimeError("injected device failure")

    with ServingHTTPServer(eng) as srv:
        srv._lock = _LateLock(srv)
        got = {}

        def client():
            try:
                urllib.request.urlopen(
                    _completion_request(srv, _prompt(6, 5)), timeout=30)
                got["code"] = 200
            except urllib.error.HTTPError as e:
                got["code"] = e.code
            except OSError as e:  # a timeout: the request hung
                got["code"] = repr(e)

        t = threading.Thread(target=client)
        t.start()
        time.sleep(0.3)  # the handler waits at the lock
        eng.has_work = lambda: True
        eng.step = bad_step
        srv._wake.set()
        t.join(timeout=60)
    assert got.get("code") == 503, got


def test_handlers_go_before_the_next_step(params):
    """A fault of the reference the port does not copy (ROADMAP queue 3):
    the JAX driver takes the engine lock back straight after each step, so
    while the engine is busy a handler (/health here; /v1/cancel and new
    requests alike) waits for a gap that may not come for many steps (JAX's
    server: 364 steps of 5 ms, or until the engine idles).  The port's
    driver lets a waiting handler in before its next step."""
    eng = make_engine(params)
    steps = []

    def slow_step():  # a busy engine: 20 ms a step under the lock
        steps.append(1)
        time.sleep(0.02)

    with ServingHTTPServer(eng) as srv:
        eng.has_work = lambda: len(steps) < 1000
        eng.step = slow_step
        srv._wake.set()
        time.sleep(0.1)
        waited = []
        for _ in range(5):
            n0 = len(steps)
            urllib.request.urlopen(url(srv, "/health"), timeout=60).read()
            waited.append(len(steps) - n0)
        eng.has_work = lambda: False
    # the steps that pass while the request is read and parsed, then at
    # most the one running when the handler asks for the lock
    assert max(waited) <= 10, waited


def test_cancel_mid_stream_is_served_while_the_engine_runs(params):
    """A /v1/cancel posted at a stream's first token is served while the
    request runs: the stream ends cancelled, short, every page back."""
    with ServingHTTPServer(make_engine(params)) as srv:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=120)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": _prompt(7, 6).tolist(),
                                 "max_tokens": 120, "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        rid = json.loads(resp.readline())["id"]
        assert post(srv, "/v1/cancel", {"id": rid})["cancelled"] is True
        lines = [json.loads(raw) for raw in resp if raw.strip()]
        conn.close()
        assert lines[-1]["done"] and lines[-1]["cancelled"]
        assert len(lines) < 120
        assert srv.engine.allocator.num_free == 63


def test_cancel_endpoint_bad_input(params):
    with ServingHTTPServer(make_engine(params)) as srv:
        req = urllib.request.Request(
            url(srv, "/v1/cancel"), data=json.dumps({}).encode(),
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
        assert ei.value.code == 400


def test_streaming_disconnect_cancels(params):
    """Closing the connection mid-stream frees the request's slot and
    pages instead of generating to max_tokens.  (JAX's case asks for 200
    tokens of an engine that caps a sequence at 128, so its request is
    refused with a 400 and nothing streams; here 120 fit.)"""
    with ServingHTTPServer(make_engine(params)) as srv:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=120)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": _prompt(5, 6).tolist(),
                                 "max_tokens": 120, "stream": True}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        # one token arrived; the request is running
        assert "token" in json.loads(resp.readline())
        conn.close()     # client disconnect
        deadline = time.time() + 120
        while time.time() < deadline:
            health = json.loads(urllib.request.urlopen(
                url(srv, "/health"), timeout=60).read())
            if health["running"] == 0 and health["waiting"] == 0:
                break
            time.sleep(0.2)
        else:
            pytest.fail("orphaned stream still running after 120 s")
        assert 0 < health["tokens_generated"] < 120
        assert health["free_pages"] == 63  # every page back
