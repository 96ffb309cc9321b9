"""The port's HTTP layer (chitu_tpu_torch/serve.py) end to end over a real
socket on the CPU: /v1/chat/completions streaming and not, the probe
endpoints, and clean rejections."""

import dataclasses
import json

import pytest
import requests

from chitu_tpu_torch import load_config
from chitu_tpu_torch.serve import BackgroundServer

TINY = [
    "models=micro-llama-debug", "infer.max_seq_len=128", "infer.max_reqs=4",
    "infer.page_size=16", "request.max_new_tokens=8",
]


@pytest.fixture(scope="module")
def base_url():
    cfg = load_config(overrides=TINY)
    cfg = dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, port=0))
    srv = BackgroundServer(cfg, warmup=True, device="cpu")
    port = srv.start()
    yield f"http://127.0.0.1:{port}"
    srv.stop()


def test_probe_endpoints(base_url):
    assert requests.get(f"{base_url}/ping").json() == {"message": "pong"}
    assert requests.get(f"{base_url}/health").status_code == 200
    st = requests.get(f"{base_url}/status").json()
    assert st["engine"] == "RUNNING"
    assert st["adaptive_window"]["kappa_src"] == "calibrated"  # warmup seeded it
    ls = requests.get(f"{base_url}/load_status").json()
    assert set(ls) == {"load", "num_reqs", "max_reqs"}


@pytest.mark.parametrize(
    "messages",
    ["hello there", [{"role": "system", "content": "be brief"},
                     {"role": "user", "content": "hi"}]],
)
def test_full_completion(base_url, messages):
    r = requests.post(
        f"{base_url}/v1/chat/completions",
        json={"messages": messages, "temperature": 0.0, "max_tokens": 6,
              "stream": False},
        timeout=120,
    )
    assert r.status_code == 200
    data = r.json()
    assert data["object"] == "chat.completion"
    assert data["usage"]["completion_tokens"] <= 6
    assert data["choices"][0]["message"]["role"] == "assistant"
    assert data["choices"][0]["finish_reason"] in ("stop", "length")


def test_streaming_sse(base_url):
    events = []
    with requests.post(
        f"{base_url}/v1/chat/completions",
        json={"messages": "stream test", "max_tokens": 5, "stream": True,
              "temperature": 0.7, "top_k": 8},
        stream=True,
        timeout=120,
    ) as r:
        assert r.status_code == 200
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for line in r.iter_lines():
            if line.startswith(b"data: "):
                events.append(line[6:].decode())
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert chunks[0]["object"] == "chat.completion.chunk"
    assert chunks[-1]["usage"]["completion_tokens"] <= 5
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")


def test_rejections(base_url):
    r = requests.post(
        f"{base_url}/v1/chat/completions",
        json={"messages": "y" * 500, "max_tokens": 5}, timeout=120,
    )
    assert r.status_code == 400 and "max_seq_len" in r.json()["detail"]
    r = requests.post(
        f"{base_url}/v1/chat/completions", json={"messages": 42}, timeout=120
    )
    assert r.status_code == 422
