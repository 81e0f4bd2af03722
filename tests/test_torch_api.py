"""The port's HTTP front end (``micromix_tpu_torch.serve.api``) and router
(``serve.router``), the cases of tests/test_api.py over a tiny CPU engine.

A real ThreadingHTTPServer on an ephemeral port: blocking and streaming
completions, concurrent clients, stop strings and stop ids, logprobs,
chat, the ops endpoints and a malformed body.  A whitespace-integer
"tokenizer" keeps text and ids trivially invertible.  Every greedy
completion equals ``Engine.run`` of the same prompt on a fresh engine
over the same params (tokens equal, no tolerance: the same program on
the same inputs).  The router is held against the JAX package's
``Router`` class driving the same port engines: the same replica for
each request, the same ``stats`` and ``cancel`` results; a two-replica
router gives the tokens of one engine.
"""

import http.client
import json
import threading

import pytest

from port_threads import one_torch_thread  # noqa: F401 (autouse)

from micromix_tpu.serve.router import Router as JRouter
from micromix_tpu_torch.models import ModelConfig, random_dense_params
from micromix_tpu_torch.serve import ApiServer, Engine, Request, Router

CFG = ModelConfig(arch="llama", vocab_size=96, hidden_size=128,
                  intermediate_size=256, num_layers=2, num_heads=2,
                  num_kv_heads=2, head_dim=64, rope_theta=10000.0,
                  rms_eps=1e-6)
ENGINE_KW = dict(max_seqs=2, page_size=16, max_pages_per_seq=8,
                 prefill_buckets=(16, 32), decode_chunk=2, device="cpu")


def _encode(s):
    return [int(w) for w in s.split()]


def _decode(ids):
    return " ".join(str(int(i)) for i in ids)


@pytest.fixture(scope="module")
def params():
    return random_dense_params(CFG, seed=7, device="cpu")


def _greedy(params, prompts, n):
    """Engine.run of the prompts on a fresh engine -> their tokens."""
    eng = Engine(params, CFG, **ENGINE_KW)
    reqs = eng.run([Request(i, _encode(p), max_new_tokens=n)
                    for i, p in enumerate(prompts)])
    return [r.output for r in reqs]


@pytest.fixture(scope="module")
def server(params):
    eng = Engine(params, CFG, **ENGINE_KW)
    srv = ApiServer(eng, _encode, _decode, model_name="tiny-llama",
                    chat_template=lambda msgs: " ".join(
                        m.get("content", "") for m in msgs))
    srv.start()
    yield srv
    srv.close()


def _post(srv, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=300)
    conn.request("POST", path, json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _get(srv, path):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, data


def _stream(srv, path, body):
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=300)
    conn.request("POST", path, json.dumps(dict(body, stream=True)),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    assert resp.getheader("Content-Type") == "text/event-stream"
    raw = resp.read().decode()
    conn.close()
    return [ln[len("data: "):] for ln in raw.splitlines()
            if ln.startswith("data: ")]


def test_completion_roundtrip(server, params):
    status, data = _post(server, "/v1/completions",
                         {"prompt": "5 6 7", "max_tokens": 4})
    assert status == 200
    out = json.loads(data)
    assert out["object"] == "text_completion"
    assert out["model"] == "tiny-llama"
    choice = out["choices"][0]
    assert _encode(choice["text"]) == _greedy(params, ["5 6 7"], 4)[0]
    assert choice["finish_reason"] == "length"
    assert out["usage"] == {"prompt_tokens": 3, "completion_tokens": 4,
                            "total_tokens": 7}


def test_minp_through_api(server):
    """min_p=1.0 at temperature 1.0 keeps only the argmax: the greedy
    completion of the same prompt."""
    _, d1 = _post(server, "/v1/completions",
                  {"prompt": "15 16", "max_tokens": 3,
                   "temperature": 1.0, "min_p": 1.0})
    _, d2 = _post(server, "/v1/completions",
                  {"prompt": "15 16", "max_tokens": 3})
    assert json.loads(d1)["choices"][0]["text"] == \
        json.loads(d2)["choices"][0]["text"]


def test_pretokenized_prompt_and_logprobs(server, params):
    status, data = _post(server, "/v1/completions",
                         {"prompt": [9, 10, 11], "max_tokens": 3,
                          "logprobs": True})
    assert status == 200
    out = json.loads(data)
    lp = out["choices"][0]["logprobs"]["token_logprobs"]
    assert len(lp) == 3 and all(p <= 0.0 for p in lp)
    assert _encode(out["choices"][0]["text"]) == \
        _greedy(params, ["9 10 11"], 3)[0]


@pytest.mark.parametrize("chat", [False, True])
def test_streaming_sse(server, params, chat):
    """SSE chunks ('data: ...' events, [DONE] last) whose deltas join to
    the blocking answer; chat streams announce the role first."""
    if chat:
        body = {"messages": [{"role": "user", "content": "7 8"}],
                "max_tokens": 3}
        events = _stream(server, "/v1/chat/completions", body)
        objs = [json.loads(e) for e in events[:-1]]
        assert objs[0]["object"] == "chat.completion.chunk"
        assert objs[0]["choices"][0]["delta"] == {"role": "assistant"}
        text = "".join(o["choices"][0]["delta"].get("content", "")
                       for o in objs)
        prompt, n = "7 8", 3
    else:
        events = _stream(server, "/v1/completions",
                         {"prompt": "1 2 3", "max_tokens": 4})
        objs = [json.loads(e) for e in events[:-1]]
        text = "".join(o["choices"][0]["text"] for o in objs)
        prompt, n = "1 2 3", 4
    assert events[-1] == "[DONE]"
    assert objs[-1]["choices"][0]["finish_reason"] == "length"
    assert _encode(text) == _greedy(params, [prompt], n)[0]


def test_concurrent_clients(server, params):
    results = {}

    def go(i):
        _, data = _post(server, "/v1/completions",
                        {"prompt": f"{i} {i + 1}", "max_tokens": 3})
        results[i] = json.loads(data)

    ts = [threading.Thread(target=go, args=(i,)) for i in (20, 30, 40)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    ref = _greedy(params, [f"{i} {i + 1}" for i in (20, 30, 40)], 3)
    assert [_encode(results[i]["choices"][0]["text"]) for i in (20, 30, 40)] \
        == ref


def test_stop_string_truncates(server):
    _, data = _post(server, "/v1/completions",
                    {"prompt": "8 9", "max_tokens": 6})
    full = _encode(json.loads(data)["choices"][0]["text"])
    stop = f"{full[2]} {full[3]}"
    _, data = _post(server, "/v1/completions",
                    {"prompt": "8 9", "max_tokens": 6, "stop": stop})
    out = json.loads(data)
    assert out["choices"][0]["finish_reason"] == "stop"
    got = out["choices"][0]["text"]
    assert stop not in got
    assert len(_encode(got)) < len(full)
    assert _decode(full).startswith(got.strip() or got)


def test_stop_token_ids(server):
    _, data = _post(server, "/v1/completions",
                    {"prompt": "3 4", "max_tokens": 6})
    full = _encode(json.loads(data)["choices"][0]["text"])
    _, data = _post(server, "/v1/completions",
                    {"prompt": "3 4", "max_tokens": 6,
                     "stop_token_ids": [full[1]]})
    out = json.loads(data)
    # the engine stops at the first occurrence of the stop token, which
    # the response leaves out
    assert _encode(out["choices"][0]["text"]) == full[:full.index(full[1])]
    assert out["choices"][0]["finish_reason"] == "stop"


def test_chat_completion(server):
    status, data = _post(server, "/v1/chat/completions",
                         {"messages": [{"role": "user",
                                        "content": "12 13 14"}],
                          "max_tokens": 3})
    assert status == 200
    out = json.loads(data)
    assert out["object"] == "chat.completion"
    msg = out["choices"][0]["message"]
    assert msg["role"] == "assistant"
    _, data2 = _post(server, "/v1/completions",
                     {"prompt": "12 13 14", "max_tokens": 3})
    assert json.loads(data2)["choices"][0]["text"].strip() == \
        msg["content"].strip()
    assert len(_encode(msg["content"])) == 3


def test_ops_endpoints_and_bad_request(server):
    status, data = _get(server, "/health")
    assert status == 200 and json.loads(data)["status"] == "ok"
    status, data = _get(server, "/v1/models")
    assert status == 200
    assert json.loads(data)["data"][0]["id"] == "tiny-llama"
    status, data = _get(server, "/metrics")
    assert status == 200
    text = data.decode()
    for key in ("micromix_requests_total", "micromix_requests_live",
                "micromix_decode_tokens_total", "micromix_prefill_tokens_total",
                "micromix_preemptions_total", "micromix_ttft_seconds_count"):
        assert key in text
    status, _ = _get(server, "/nope")
    assert status == 404
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    conn.request("POST", "/v1/completions", "{not json",
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 400
    resp.read()
    conn.close()


def _router_reqs():
    lens = (12, 3, 20, 5, 9)
    return [Request(i, [(7 * i + j) % CFG.vocab_size for j in range(n)],
                    max_new_tokens=2 + i) for i, n in enumerate(lens)]


def test_router_follows_the_jax_router(params):
    """The port's Router and the JAX package's Router class, each over two
    fresh port engines, given the same requests: the same replica for
    each, the same cancel results and stats; every token equal to one
    engine's run of the same requests."""
    picks, stats, tokens = [], [], []
    for cls in (Router, JRouter):
        router = cls([Engine(params, CFG, **ENGINE_KW) for _ in range(2)])
        reqs = _router_reqs()
        picks.append([router.submit(r) for r in reqs])
        router.step()
        cancels = [router.cancel(4), router.cancel(99)]
        while router.step():
            pass
        stats.append((router.stats, cancels))
        tokens.append([r.output for r in reqs[:4]])
    assert picks[0] == picks[1] and len(set(picks[0])) == 2
    assert stats[0] == stats[1] and stats[0][1] == [True, False]
    assert tokens[0] == tokens[1]
    one = Engine(params, CFG, **ENGINE_KW).run(_router_reqs())
    two = Router([Engine(params, CFG, **ENGINE_KW) for _ in range(2)]).run(
        _router_reqs())
    assert [r.output for r in two] == [r.output for r in one]
