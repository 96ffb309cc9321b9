"""chitu_tpu_torch/evals.py against chitu_tpu/evals.py, on the CPU, and the
counterparts of tests/test_evals.py.

One micro-llama-debug checkpoint (bf16, written from a numpy draw of a
fixed seed) is loaded by the port's and the JAX package's engines.
Limit: the two perplexities of one token sequence agree within 1e-3
relative. Both prefill every window teacher-forced in bf16 and sum the
log-probabilities in f32 or wider; their logits differ by the rounding of
two sound bf16 forwards. Measured: 2.5e-6 to 1.6e-5 (random weights put
the perplexity near the vocabulary size, 522 of 512).
"""

import contextlib
import importlib
import io
import json
import sys

import pytest
import torch

from chitu_tpu.engine import Engine as JEngine
from chitu_tpu.evals import perplexity_from_tokens as jppl
from chitu_tpu_torch import evals
from chitu_tpu_torch.engine import Engine

from test_torch_loader import (
    DEEPSEEK,
    LLAMA,
    LLAMA_FP8,
    _cfgs,
    _deepseek_fp8,
    deepseek_tensors,
    llama_tensors,
    to_fp8,
    write,
)

REL = 1e-3
TOKENS = torch.randint(3, 500, (150,), generator=torch.Generator().manual_seed(5)).tolist()


@pytest.fixture(autouse=True)
def _jax_op_impl_auto():
    """The JAX op_impl switch at "auto" around each test (ROADMAP C.1)."""
    mod = importlib.import_module("chitu_tpu.ops.linear")
    old = mod._OP_IMPL
    mod._OP_IMPL = "auto"
    yield
    mod._OP_IMPL = old


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ppl"))
    return write(llama_tensors(LLAMA, 11, embed=1.0), d, torch.bfloat16)


@pytest.fixture(scope="module")
def engine(ckpt):
    return Engine(_cfgs(LLAMA, ckpt)[1], device="cpu")


@pytest.fixture(scope="module")
def jengine(ckpt):
    return JEngine(_cfgs(LLAMA, ckpt)[0])


@pytest.mark.parametrize("window,stride", [(64, None), (64, 24), (128, None)])
def test_perplexity_matches_jax(engine, jengine, window, stride):
    want = jppl(jengine, TOKENS, window=window, stride=stride)
    got = evals.perplexity_from_tokens(engine, TOKENS, window=window, stride=stride)
    assert abs(got - want) / want < REL, (got, want)


def test_deepseek_perplexity_matches_jax(tmp_path):
    """The two layer groups' pools (`kv_dense`, `kv_moe`) of a DeepSeek
    engine, on its published fp8 layout."""
    d = write(_deepseek_fp8(deepseek_tensors(DEEPSEEK, 13, embed=1.0)), str(tmp_path))
    jcfg, cfg = _cfgs(DEEPSEEK, d)
    want = jppl(JEngine(jcfg), TOKENS[:80], window=64, stride=32)
    got = evals.perplexity_from_tokens(Engine(cfg, device="cpu"), TOKENS[:80],
                                       window=64, stride=32)
    assert abs(got - want) / want < REL, (got, want)


def test_perplexity_finite(engine):
    text = "the quick brown fox jumps over the lazy dog. " * 8
    ppl = evals.perplexity_from_text(engine, text, window=64)
    assert 1.0 < ppl < engine.cfg.models.vocab_size * 2


def test_perplexity_deterministic(engine):
    toks = list(range(40, 140))
    assert (evals.perplexity_from_tokens(engine, toks, window=64)
            == evals.perplexity_from_tokens(engine, toks, window=64))
    assert engine.cache.allocator.num_free() == engine.cache.num_pages


def test_quantized_ppl_close_to_bf16(ckpt, engine):
    """Accuracy gate: soft-fp8 on load within a few percent of bf16."""
    q = Engine(_cfgs(LLAMA, ckpt, ["quant.method=soft_fp8", "quant.quant_on_load=true"])[1],
               device="cpu")
    base = evals.perplexity_from_tokens(engine, TOKENS, window=64)
    quant = evals.perplexity_from_tokens(q, TOKENS, window=64)
    assert abs(quant - base) / base < 0.05


def test_fp8_checkpoint_ppl_close_to_bf16(tmp_path):
    """A blockwise-fp8 checkpoint (the counterpart of the JAX package's
    requantized-storage gate: here the stored bytes are fp8) within a few
    percent of the bf16 checkpoint of the same draw."""
    t = llama_tensors(LLAMA_FP8, 12, embed=1.0)
    base = Engine(_cfgs(LLAMA_FP8, write(t, str(tmp_path / "bf16"), torch.bfloat16))[1],
                  device="cpu")
    fp8 = Engine(_cfgs(LLAMA_FP8, write(to_fp8(t, lambda k: k.endswith("_proj.weight")),
                                        str(tmp_path / "fp8")))[1], device="cpu")
    a = evals.perplexity_from_tokens(base, TOKENS, window=64)
    b = evals.perplexity_from_tokens(fp8, TOKENS, window=64)
    assert abs(b - a) / a < 0.05


def test_cli_prints_the_engine_perplexity(ckpt, engine, tmp_path):
    text = tmp_path / "t.txt"
    text.write_text("the quick brown fox jumps over the lazy dog. " * 8)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = evals._cli([*LLAMA, f"models.ckpt_dir={ckpt}", "infer.do_load=true",
                         f"eval.text={text}", "eval.window=64", "device=cpu"])
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    want = evals.perplexity_from_text(engine, text.read_text(), window=64)
    assert rc == 0 and res["device"] == "cpu"
    assert res["engine_ppl"] == round(want, 4)


def test_cli_hf_branch_names_the_missing_package(tmp_path, monkeypatch):
    text = tmp_path / "t.txt"
    text.write_text("x")
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(SystemExit, match="transformers"):
        evals._cli(["--hf", str(tmp_path), f"eval.text={text}"])
    with pytest.raises(SystemExit, match="eval.text"):
        evals._cli([*LLAMA])
