"""Engine configuration for chitu-tpu.

Capability parity with the reference's Hydra config tree
(reference: chitu/config/serve_config.yaml:1-47 and chitu/config/models/*.yaml),
re-designed as frozen dataclasses threaded explicitly through the engine
instead of module-level global args (reference anti-pattern noted in
SURVEY.md §5: chitu/global_vars.py:77-85).

YAML model cards live in chitu_tpu_torch/configs/models/*.yaml and can be loaded by
name; every field is overridable via dotted key=value strings
(``load_config(overrides=["infer.tp_size=8", "models=Llama-3-8B"])``) which
mirrors the reference's Hydra CLI surface (reference: README.md:95-129).

The cards are read by `read_yaml`, a small reader for the subset of YAML
they use (two-level `key: value` maps, comments, quoted strings), so the
engine needs no PyYAML. Scalars resolve the way `yaml.safe_load` resolves
them (YAML 1.1 rules: ``1e-05`` without a dot stays a string).

The dataclass tree is the JAX package's, field for field, so that the same
overrides give equal trees in both packages; the field comments describe
the JAX engine. `infer.attn_type` and `infer.op_impl` mean what they mean
there: attn_type xla|ref sends every attention call to the plain PyTorch
versions of the kernels (the jnp oracle's counterpart), on the card too;
op_impl=xla sends the calls that JAX's `get_op_impl()` governs (the
quantized and int8 GEMMs, B13, the W8A8 activation quantizers, the MLA
absorb projections) to theirs; auto|pallas keep the CUDA kernels, and any
other value raises. Fields this port does not read yet (the ring,
speculative and some quantization settings) are kept for the equality;
the engine raises for the values it cannot serve.
"""

from __future__ import annotations

import dataclasses
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

_CONFIG_DIR = os.path.join(os.path.dirname(__file__), "configs")


# ---------------------------------------------------------------------------
# Model architecture card
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEArgs:
    """Mixture-of-experts architecture parameters (DeepSeek-V3 / Mixtral).

    Mirrors the reference's model-card MoE block
    (reference: chitu/config/models/DeepSeek-R1.yaml:1-29).
    """

    n_routed_experts: int = 0
    n_shared_experts: int = 0
    n_activated_experts: int = 0  # top-k
    n_expert_groups: int = 1
    n_limited_groups: int = 1
    score_func: str = "softmax"  # "softmax" | "sigmoid"
    route_scale: float = 1.0
    moe_inter_dim: int = 0
    # first n_dense_layers use a dense FFN instead of MoE (DeepSeek)
    n_dense_layers: int = 0
    norm_topk_prob: bool = True
    # capacity-einsum fallback sizing (the sorted-dispatch path is exact
    # and ignores this); tokens beyond an expert's capacity are dropped
    # on the fallback, so raise for skewed prefill loads under pp>1
    capacity_factor: float = 2.0


@dataclass(frozen=True)
class MLAArgs:
    """Multi-head latent attention dims (DeepSeek-V3).

    reference: chitu/models/model_deepseek_v3.py:403-474.
    """

    q_lora_rank: int = 0
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class RopeScalingArgs:
    """YaRN-style rope scaling (reference: model_deepseek_v3.py:1353-1445)."""

    kind: str = "none"  # "none" | "yarn" | "linear"
    factor: float = 1.0
    original_max_position: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclass(frozen=True)
class ModelArgs:
    """Architecture card for one model family.

    Covers the union of the reference's 8 model cards
    (reference: chitu/config/models/*.yaml).
    """

    name: str = "tiny-llama-debug"
    type: str = "hf-llama"  # hf-llama | llama | mixtral | deepseek-v3
    source: str = ""
    ckpt_dir: str = ""
    tokenizer_path: str = ""

    vocab_size: int = 32000
    dim: int = 2048
    n_layers: int = 22
    n_heads: int = 32
    n_kv_heads: int = 4
    head_dim: int = 0  # 0 -> dim // n_heads
    inter_dim: int = 5632
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False

    # rotary layout: "hf-llama" (half-split) | "llama" (interleaved) | "glm4"
    # (reference: chitu/ops.py:94-326)
    rotary_type: str = "hf-llama"
    # fraction of head_dim that is rotary (glm4 uses 0.5)
    partial_rotary_factor: float = 1.0
    # qkv bias (qwen2 uses attention bias)
    attn_bias: bool = False
    # sliding-window attention: tokens attend only to the last N positions
    # (0 = full attention; reference: attn_backend.py:43-44 window_size)
    sliding_window: int = 0
    # logit soft-capping: s = tanh(s / cap) * cap (gemma2-style;
    # reference: attn_backend.py:84-85 softcap)
    attn_softcap: float = 0.0

    # Meta-llama FFN sizing (reference: model_llama.py:131-158); used when
    # inter_dim == 0 and type == "llama".
    multiple_of: int = 256
    ffn_dim_multiplier: float = 0.0

    # reasoning-stream split tokens (<think> ... </think>) for R1-style models
    # (reference: async_response.py:57-71, model cards rs_token_id/re_token_id)
    rs_token_id: Optional[int] = None
    re_token_id: Optional[int] = None
    # some tokenizers (mixtral sentencepiece) need full-sequence re-decode for
    # correct whitespace (reference: Mixtral card tokenizer_force_full_seq_decode)
    tokenizer_force_full_seq_decode: bool = False

    moe: Optional[MoEArgs] = None
    mla: Optional[MLAArgs] = None
    rope_scaling: Optional[RopeScalingArgs] = None

    # dtype of weights as loaded ("bfloat16" | "float16" | "float8_e4m3fn")
    weight_dtype: str = "bfloat16"

    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.dim // self.n_heads


# ---------------------------------------------------------------------------
# Engine / serving config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ServeArgs:
    host: str = "0.0.0.0"
    port: int = 21002
    # predicted-wait admission SLO (seconds, 0 = legacy 4x-max_reqs cap
    # only): shed a request with 403 when queued / observed completion
    # rate exceeds this — queueing past the knee only converts throughput
    # into TTFT (VERDICT r4 next-6). Shed requests are cheap for clients
    # to retry against a replica (/load_status exists for exactly that).
    admission_max_wait_s: float = 0.0


@dataclass(frozen=True)
class InferArgs:
    """Engine execution parameters (reference: serve_config.yaml:4-24)."""

    tp_size: int = 1
    pp_size: int = 1
    dp_size: int = 1
    ep_size: int = 1  # expert parallelism degree (over the tp axis)
    do_load: bool = False  # False -> random weights (arch-only debug)
    seed: int = 0
    stop_with_eos: bool = True
    max_seq_len: int = 2048
    # "paged" | "dense" | "nop"  (reference cache_type normal/paged/skew/nop)
    cache_type: str = "paged"
    # fraction of the fully-provisioned paged pool to allocate (< 1.0
    # means max_reqs full-length contexts can NOT all fit — the engine's
    # KV-pressure preemption + prefix-cache eviction then actually fire;
    # also how a big-model deployment fits weights + KV on one chip)
    kv_pool_frac: float = 1.0
    # 256-token pages amortize DMA latency on TPU (measured 3x effective
    # bandwidth vs 64 at ctx 2048); the reference uses block 256 for
    # non-MLA models too (backend.py:234-237)
    page_size: int = 256
    # "pallas" | "ref"  (attn_type spectrum of the reference collapses to
    # pallas kernels + a jnp oracle; reference: backend.py:259-270)
    attn_type: str = "auto"
    # op_impl switch, kept from the reference's portability design
    # (reference: serve_config.yaml:15): "pallas" | "xla"
    op_impl: str = "auto"
    mla_absorb: str = "absorb"  # "none" | "absorb"
    # sequence-parallel (ring-attention) prefill for long prompts: shards
    # the prompt's token dim over the mesh's 'dp' axis (idle during a
    # single prompt's prefill) and rotates K/V slices around the ring.
    # ADDITIVE over the reference (no SP there; SURVEY.md §5).
    ring_prefill: bool = False
    # ring-sharded KV cache: the paged pool's page dim shards over the
    # 'dp' axis (striped pages, owner-writes, flash-decoding stat combine
    # across shards — ops/attention_ring.py), so total KV capacity scales
    # with the ring. The batch stays replicated over 'dp' (capacity trades
    # against replica throughput — the long-context serving regime).
    # ADDITIVE over the reference; requires tp_size == pp_size == 1.
    ring_kv: bool = False
    # hybrid prefill+decode steps: when a scheduled batch holds both
    # phases, the in-flight decode rows ride the packed prefill's weight
    # pass as extra tokens in the SAME jitted forward (one GEMM stream),
    # so prompt ingest does not stall decode (the reference dispatches
    # prefill OR decode per step: executor.py:150-162).
    hybrid_step: bool = True
    # fuse qkv and gate+up projections into single GEMMs (reference policy:
    # backend.py:273-285). "auto" merges when unsharded (merged column
    # sharding would split across q/k/v segment boundaries under tp)
    merge_qkv_gate_up: str = "auto"  # auto | on | off
    soft_fp8: bool = False
    max_reqs: int = 16
    # decode jit batch buckets (CUDA-graph analogue; reference: model.py:547-622)
    decode_buckets: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)
    # tokens decoded per jitted call with on-device sampling feedback; the
    # host syncs once per window (amortizes dispatch/fetch latency the way
    # the reference's CUDA graphs amortize kernel launches)
    decode_window: int = 16
    # adaptive window length: pick the bucket (pow-4 ladder below
    # decode_window) maximizing useful slot-steps per unit time from each
    # row's known remaining budget — tail batches run SHORT windows and
    # free their slots instead of idling them for a full window
    adaptive_window: bool = True

    # multi-process bring-up (reference: backend.py:88-89
    # init_process_group + script/srun_multi_node.sh): coordinator
    # "host:port" (or a file:// URL) + process count/id wire
    # torch.distributed (`parallel/distributed.py`); env fallbacks
    # CHITU_TPU_COORDINATOR / CHITU_TPU_NUM_PROCESSES /
    # CHITU_TPU_PROCESS_ID.
    coordinator: str = ""
    num_processes: int = 1
    process_id: int = -1
    prefill_chunk: int = 512  # prefill token-count bucket granularity
    # kept for the cards' sake and read nowhere, as in the JAX package:
    # pipeline stages always hold equal layer ranges
    pp_layer_partition: Tuple[int, ...] = ()
    # KV-cache storage dtype (ADDITIVE over the reference, which caches
    # fp16/bf16 only): "fp8" stores e4m3 bits in int8 lanes — halves KV
    # bandwidth and doubles cache capacity; kernels dequant on load with
    # the same bit-placement trick as soft-fp8 weights.
    kv_dtype: str = "bf16"  # bf16 | fp8
    # speculative decoding (ADDITIVE over the reference): "ngram" turns on
    # draft-model-free prompt-lookup drafting — the last n-gram of the
    # context is matched against its own history and the continuation
    # proposed as K draft tokens, verified in ONE fused forward (decode is
    # HBM-bound, so verification costs ~one decode step). Greedy,
    # penalty-free requests only; others fall back to windowed decode.
    spec_decode: str = ""  # "" | "ngram"
    spec_k: int = 4  # draft tokens per verify step
    # automatic prefix caching (ADDITIVE over the reference, whose
    # PrefixAlign scheduler only sorts by shared prefix): full prompt
    # pages are content-hashed and shared read-only between requests, so
    # repeated system prompts / few-shot headers prefill only their tail.
    # Python allocator only (forces CHITU_TPU_NATIVE off for the pool).
    prefix_cache: bool = False


@dataclass(frozen=True)
class RequestDefaults:
    """Per-request defaults (reference: serve_config.yaml:25-28)."""

    prompt_tokens_len: int = 0  # >0 -> synthetic fixed-length prompts in tests
    max_new_tokens: int = 256
    temperature: float = 1.0
    top_p: float = 0.9
    top_k: int = -1
    frequency_penalty: float = 0.0


@dataclass(frozen=True)
class SchedulerArgs:
    """Scheduler policy + knobs (reference: chitu/scheduler.py:14-39)."""

    policy: str = "prefill_first"
    # prefill_first: top decode rows up into a prefill batch — the
    # executor then fuses both phases into one hybrid step
    # (infer.hybrid_step), so prompt ingest no longer stalls decode
    hybrid_fill: bool = True
    # stride
    stride_avg_priority: float = 1.0
    # deadline
    deadline_alpha: float = 0.01
    deadline_beta: float = 0.05
    # balance
    balance_ratio: float = 0.5


@dataclass(frozen=True)
class QuantArgs:
    """Quantization scheme selection (reference: serve_config.yaml quant= +
    chitu/quantize/quantizer.py:277-291)."""

    method: str = "none"  # none|soft_fp8|fp8|w8a16|w4a16_awq|w4a16_gptq|w8a8|llmint8
    quant_on_load: bool = False
    group_size: int = 128
    quant_ckpt_dir: str = ""
    # fp8 activation handling for method=fp8: "int8" approximates the
    # runtime act quant with the v5e-native int8 datapath (speed path);
    # "e4m3" rounds activations through the true fp8 grid with blockwise
    # dynamic scales (reference act_quant semantics, chitu/ops.py:329-353)
    fp8_act: str = "int8"
    # ALSO quantize lm_head (the reference never does; opt-in r5): at
    # bs=1 the bf16 head is ~9% of step bytes on the MLA geometry.
    # Skipped for tied embeddings (the lookup needs the dense table).
    quantize_head: bool = False


@dataclass(frozen=True)
class EngineConfig:
    serve: ServeArgs = field(default_factory=ServeArgs)
    infer: InferArgs = field(default_factory=InferArgs)
    request: RequestDefaults = field(default_factory=RequestDefaults)
    scheduler: SchedulerArgs = field(default_factory=SchedulerArgs)
    quant: QuantArgs = field(default_factory=QuantArgs)
    models: ModelArgs = field(default_factory=ModelArgs)
    dtype: str = "bfloat16"
    keep_dtype_in_checkpoint: bool = True
    skip_preprocess: bool = False


# ---------------------------------------------------------------------------
# YAML-subset reader
# ---------------------------------------------------------------------------

# implicit scalar resolution of PyYAML's SafeLoader (YAML 1.1)
_YAML_BOOL = {
    "yes": True, "Yes": True, "YES": True, "true": True, "True": True,
    "TRUE": True, "on": True, "On": True, "ON": True,
    "no": False, "No": False, "NO": False, "false": False, "False": False,
    "FALSE": False, "off": False, "Off": False, "OFF": False,
}
_YAML_NULL = {"", "~", "null", "Null", "NULL"}
_YAML_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_YAML_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?\.(?:inf|Inf|INF)"
    r"|\.(?:nan|NaN|NAN))$"
)


def _yaml_scalar(raw: str) -> Any:
    if len(raw) >= 2 and raw[0] == raw[-1] and raw[0] in "\"'":
        body = raw[1:-1]
        if raw[0] == "'":
            return body.replace("''", "'")
        return bytes(body, "utf-8").decode("unicode_escape")
    if raw in _YAML_NULL:
        return None
    if raw in _YAML_BOOL:
        return _YAML_BOOL[raw]
    if _YAML_INT.match(raw):
        return int(raw.replace("_", ""))
    if _YAML_FLOAT.match(raw):
        low = raw.lower()
        if low.endswith("inf"):
            return float("-inf") if low.startswith("-") else float("inf")
        if low.endswith("nan"):
            return float("nan")
        return float(raw.replace("_", ""))
    return raw


def _strip_comment(line: str) -> str:
    """Drop a `#` comment (at line start or after whitespace) that is not
    inside a quoted string."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def read_yaml(text: str) -> Dict[str, Any]:
    """Parse the YAML subset of the config cards: nested `key: value`
    maps by indentation, comments, quoted strings, YAML 1.1 scalars."""
    root: Dict[str, Any] = {}
    stack = [(-1, root)]  # (indent, mapping)
    for n, line in enumerate(text.splitlines(), 1):
        body = _strip_comment(line).rstrip()
        if not body.strip():
            continue
        indent = len(body) - len(body.lstrip(" "))
        key, sep, rest = body.strip().partition(":")
        if not sep or (rest and not rest.startswith(" ")):
            raise ValueError(f"line {n}: expected 'key: value', got {line!r}")
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        rest = rest.strip()
        if rest:
            parent[key] = _yaml_scalar(rest)
        else:
            # a key with no value opens a nested map (or is null when
            # nothing more-indented follows; fixed up below)
            child: Dict[str, Any] = {}
            parent[key] = child
            stack.append((indent, child))
    return _empty_maps_to_none(root)


def _empty_maps_to_none(d: Dict[str, Any]) -> Dict[str, Any]:
    return {
        k: (_empty_maps_to_none(v) or None) if isinstance(v, dict) else v
        for k, v in d.items()
    }


def _read_yaml_file(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return read_yaml(f.read())


# ---------------------------------------------------------------------------
# Loading / overrides
# ---------------------------------------------------------------------------


def _dataclass_from_dict(cls, data: Dict[str, Any]):
    if data is None:
        return None
    kwargs = {}
    hints = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in hints:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        f = hints[key]
        sub = _SUBTYPES.get((cls, key))
        if sub is not None and isinstance(value, dict):
            kwargs[key] = _dataclass_from_dict(sub, value)
        elif isinstance(f.default, tuple):
            kwargs[key] = tuple(value)
        elif isinstance(f.default, bool):
            kwargs[key] = bool(value)
        elif isinstance(f.default, float) and value is not None:
            # pyyaml reads "1e-05" as str; coerce by field default type
            kwargs[key] = float(value)
        elif isinstance(f.default, int) and value is not None:
            kwargs[key] = int(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


_SUBTYPES = {
    (EngineConfig, "serve"): ServeArgs,
    (EngineConfig, "infer"): InferArgs,
    (EngineConfig, "request"): RequestDefaults,
    (EngineConfig, "scheduler"): SchedulerArgs,
    (EngineConfig, "quant"): QuantArgs,
    (EngineConfig, "models"): ModelArgs,
    (ModelArgs, "moe"): MoEArgs,
    (ModelArgs, "mla"): MLAArgs,
    (ModelArgs, "rope_scaling"): RopeScalingArgs,
}


def load_model_card(name: str) -> ModelArgs:
    """Load a model card by name from chitu_tpu_torch/configs/models/<name>.yaml."""
    path = os.path.join(_CONFIG_DIR, "models", f"{name}.yaml")
    return _dataclass_from_dict(ModelArgs, _read_yaml_file(path))


def list_model_cards() -> List[str]:
    d = os.path.join(_CONFIG_DIR, "models")
    return sorted(
        os.path.splitext(p)[0] for p in os.listdir(d) if p.endswith(".yaml")
    )


def _coerce(current: Any, raw: str) -> Any:
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        raw = raw.strip("[]() ")
        if not raw:
            return ()
        return tuple(int(x) for x in raw.split(","))
    return raw


def _apply_override(cfg, dotted: str, raw: str):
    parts = dotted.split(".")
    if len(parts) == 1:
        if dotted == "models":
            return dataclasses.replace(cfg, models=load_model_card(raw))
        current = getattr(cfg, dotted)
        if dataclasses.is_dataclass(current):
            raise ValueError(f"cannot assign scalar to group {dotted!r}")
        return dataclasses.replace(cfg, **{dotted: _coerce(current, raw)})
    head, rest = parts[0], ".".join(parts[1:])
    child = getattr(cfg, head)
    if child is None:
        child = _SUBTYPES[(type(cfg), head)]()
    return dataclasses.replace(cfg, **{head: _apply_override(child, rest, raw)})


def load_config(
    config_name: str = "serve_config",
    overrides: Optional[List[str]] = None,
) -> EngineConfig:
    """Load a base EngineConfig YAML then apply dotted overrides.

    Equivalent of the reference's hydra entrypoint
    (reference: chitu/serve.py:215-218, chitu/utils.py:103-107).
    """
    path = os.path.join(_CONFIG_DIR, f"{config_name}.yaml")
    if os.path.exists(path):
        data = _read_yaml_file(path)
    else:
        data = {}
    models_name = data.pop("models", None)
    cfg = _dataclass_from_dict(EngineConfig, data)
    if isinstance(models_name, str):
        cfg = dataclasses.replace(cfg, models=load_model_card(models_name))
    elif isinstance(models_name, dict):
        cfg = dataclasses.replace(
            cfg, models=_dataclass_from_dict(ModelArgs, models_name)
        )
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, _, raw = ov.partition("=")
        cfg = _apply_override(cfg, key.strip(), raw.strip())
    return cfg
