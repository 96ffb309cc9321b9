"""Tokenizer layer.

Capability parity with the reference's tokenizer module
(reference: chitu/tokenizer.py:36-298): a HuggingFace AutoTokenizer wrapper
with chat-template support (TokenizerHF/ChatFormatHF,
reference: tokenizer.py:239-298), plus a dependency-free byte-level debug
tokenizer so the whole engine is testable with no checkpoint on disk
(TPU-build addition; the reference has no offline tokenizer).

The Meta-Llama tiktoken path (reference: tokenizer.py:36-206) is covered by
`TokenizerTiktoken`, gated on tiktoken availability.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence


class BaseTokenizer:
    """Protocol shared by all tokenizers."""

    vocab_size: int
    bos_id: Optional[int]
    eos_id: int
    stop_tokens: frozenset

    def encode(self, s: str, bos: bool = False, eos: bool = False) -> List[int]:
        raise NotImplementedError

    def decode(self, ids: Sequence[int]) -> str:
        raise NotImplementedError

    def encode_chat(self, messages: List[Dict[str, str]]) -> List[int]:
        """Encode a chat conversation, appending the assistant generation
        prompt (reference: tokenizer.py:275-298)."""
        raise NotImplementedError


class ByteTokenizer(BaseTokenizer):
    """UTF-8 byte-level tokenizer for offline tests and arch-only debugging.

    token = byte value; specials: 256=bos, 257=eos, 258=pad. Deterministic,
    lossless, needs no files.
    """

    def __init__(self, vocab_size: int = 512):
        assert vocab_size >= 259
        self.vocab_size = vocab_size
        self.bos_id = 256
        self.eos_id = 257
        self.pad_id = 258
        self.stop_tokens = frozenset({self.eos_id})

    def encode(self, s: str, bos: bool = False, eos: bool = False) -> List[int]:
        ids = list(s.encode("utf-8"))
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        # ids beyond the byte+special range (arch-only debugging emits the
        # model's full vocab) render as a visible placeholder so streams
        # still carry one glyph per token instead of silently dropping
        out = []
        run: List[int] = []
        for i in ids:
            if 0 <= i < 256:
                run.append(i)
            else:
                if run:
                    out.append(bytes(run).decode("utf-8", errors="replace"))
                    run = []
                if i > self.pad_id:
                    out.append("·")
        if run:
            out.append(bytes(run).decode("utf-8", errors="replace"))
        return "".join(out)

    def encode_chat(self, messages: List[Dict[str, str]]) -> List[int]:
        ids: List[int] = [self.bos_id]
        for m in messages:
            ids += self.encode(f"<{m['role']}>{m['content']}</{m['role']}>")
        ids += self.encode("<assistant>")
        return ids

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.decode([i]) for i in ids]


class TokenizerHF(BaseTokenizer):
    """HuggingFace AutoTokenizer wrapper (reference: tokenizer.py:239-272)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self.tk = AutoTokenizer.from_pretrained(path, trust_remote_code=True)
        self.vocab_size = len(self.tk)
        self.bos_id = self.tk.bos_token_id
        self.eos_id = self.tk.eos_token_id
        stops = {self.eos_id}
        # some chats use <|eot_id|>-style end-of-turn tokens
        for tok in ("<|eot_id|>", "<|im_end|>", "<|end_of_text|>", "<|user|>"):
            tid = self.tk.convert_tokens_to_ids(tok)
            if tid is not None and tid >= 0 and tid != self.tk.unk_token_id:
                stops.add(tid)
        self.stop_tokens = frozenset(t for t in stops if t is not None)

    def encode(self, s: str, bos: bool = False, eos: bool = False) -> List[int]:
        # qwen2-style tokenizers have no bos (reference: tokenizer.py:254-260)
        ids = self.tk.encode(s, add_special_tokens=False)
        if bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        if eos and self.eos_id is not None:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return self.tk.decode(list(ids), skip_special_tokens=False)

    def encode_chat(self, messages: List[Dict[str, str]]) -> List[int]:
        return self.tk.apply_chat_template(
            messages, tokenize=True, add_generation_prompt=True
        )

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return self.tk.convert_ids_to_tokens(list(ids))


class TokenizerTiktoken(BaseTokenizer):
    """Meta-Llama-3 tiktoken BPE tokenizer (reference: tokenizer.py:36-236).

    Loads the `tokenizer.model` BPE rank file and registers llama-3's
    special tokens, including 256 reserved ids.
    """

    NUM_RESERVED = 256
    PAT = r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"  # noqa: E501

    def __init__(self, model_path: str):
        import tiktoken
        from tiktoken.load import load_tiktoken_bpe

        ranks = load_tiktoken_bpe(model_path)
        num_base = len(ranks)
        specials = [
            "<|begin_of_text|>",
            "<|end_of_text|>",
            "<|reserved_special_token_0|>",
            "<|reserved_special_token_1|>",
            "<|finetune_right_pad_id|>",
            "<|step_id|>",
            "<|start_header_id|>",
            "<|end_header_id|>",
            "<|eom_id|>",
            "<|eot_id|>",
            "<|python_tag|>",
        ]
        specials += [
            f"<|reserved_special_token_{i}|>"
            for i in range(2, self.NUM_RESERVED - len(specials) + 2)
        ]
        self.special_tokens = {
            tok: num_base + i for i, tok in enumerate(specials)
        }
        self.model = tiktoken.Encoding(
            name=os.path.basename(model_path),
            pat_str=self.PAT,
            mergeable_ranks=ranks,
            special_tokens=self.special_tokens,
        )
        self.vocab_size = num_base + len(specials)
        self.bos_id = self.special_tokens["<|begin_of_text|>"]
        self.eos_id = self.special_tokens["<|end_of_text|>"]
        self.eot_id = self.special_tokens["<|eot_id|>"]
        self.stop_tokens = frozenset({self.eos_id, self.eot_id})

    def encode(self, s: str, bos: bool = False, eos: bool = False) -> List[int]:
        # chunked encode to bound tiktoken's quadratic behavior on huge
        # inputs (reference: tokenizer.py:120-160 uses 400k char chunks);
        # chunks split at whitespace so no BPE merge spans a boundary
        # (an arbitrary cut changes the tokenization vs unchunked)
        CHUNK = 400_000
        ids: List[int] = []
        off = 0
        n = len(s)
        while off < n or (off == 0 and n == 0):
            end = min(off + CHUNK, n)
            if end < n:
                ws = s.rfind(" ", off + CHUNK // 2, end)
                if ws > off:
                    end = ws
            # specials in CONTENT are plain text, never control tokens —
            # "all" would let user text forge turn boundaries / EOS
            # (chat structure uses explicit ids, _encode_header)
            ids += self.model.encode(s[off:end], disallowed_special=())
            if end == off:
                break
            off = end
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return self.model.decode(list(ids))

    def encode_chat(self, messages: List[Dict[str, str]]) -> List[int]:
        # llama-3 chat format (reference: tokenizer.py:209-236)
        ids = [self.bos_id]
        for m in messages:
            ids += self._encode_header(m["role"])
            ids += self.encode(m["content"].strip())
            ids.append(self.eot_id)
        ids += self._encode_header("assistant")
        return ids

    def _encode_header(self, role: str) -> List[int]:
        ids = [self.special_tokens["<|start_header_id|>"]]
        ids += self.encode(role)
        ids.append(self.special_tokens["<|end_header_id|>"])
        ids += self.encode("\n\n")
        return ids

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.model.decode([i]) for i in ids]


def build_tokenizer(model_args, infer_args=None) -> BaseTokenizer:
    """Pick a tokenizer implementation for a model card
    (reference: chitu/backend.py:127-166)."""
    path = model_args.tokenizer_path or model_args.ckpt_dir
    if not path:
        return ByteTokenizer(max(model_args.vocab_size, 512))
    if os.path.isfile(path) and path.endswith(".model"):
        try:
            return TokenizerTiktoken(path)
        except ImportError:
            raise RuntimeError("tiktoken unavailable for .model tokenizer")
    if os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, f))
        for f in ("tokenizer_config.json", "tokenizer.json", "tokenizer.model")
    ):
        return TokenizerHF(path)
    return ByteTokenizer(max(model_args.vocab_size, 512))
