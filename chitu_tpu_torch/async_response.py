"""Streaming response plumbing.

Capability parity with the reference's async_response module
(reference: chitu/async_response.py:1-167):

- `AsyncDataStream`: thread-safe incremental token->text decoding with
  U+FFFD (incomplete UTF-8 sequence) buffering, optional full-sequence
  re-decode mode, and `<think>`-style reasoning-token splitting.
- `AsyncResponse`: OpenAI-style chat completion responses — SSE stream
  chunks carrying `content` / `reasoning_content` deltas plus a final
  usage block, or a single full JSON body.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
import uuid
from typing import AsyncIterator, List, Optional, Tuple


class AsyncDataStream:
    """Incremental detokenizer + async iterator over produced text pieces.

    Tokens are appended from the engine worker thread; text is consumed from
    the asyncio event loop thread (reference: async_response.py:14-87).
    """

    def __init__(
        self,
        tokenizer,
        rs_token_id: Optional[int] = None,
        re_token_id: Optional[int] = None,
        force_full_seq_decode: bool = False,
    ):
        self.tokenizer = tokenizer
        self.rs_token_id = rs_token_id
        self.re_token_id = re_token_id
        self.force_full_seq_decode = force_full_seq_decode

        self.tokens: List[int] = []
        # (text, is_reasoning) pieces ready for the consumer
        self.strs: List[Tuple[str, bool]] = []
        self.lock = threading.Lock()
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self.event: Optional[asyncio.Event] = None
        self.finished = False
        self.in_reasoning = False

        # decode state: tokens[decoded_upto:] have not yet produced stable text
        self._decoded_upto = 0
        self._emitted_chars = 0  # only for full-seq mode

    def _bind_loop(self):
        if self.event is None:
            self.loop = asyncio.get_running_loop()
            self.event = asyncio.Event()

    def _notify(self):
        if self.event is not None and self.loop is not None:
            self.loop.call_soon_threadsafe(self.event.set)

    def add_data(self, token_id: int):
        """Append one generated token (engine thread).

        Decoding to text is DEFERRED to the consumer side (_drain): the
        reference detokenizes on the engine thread per token
        (reference: async_response.py:34-50), which costs ~4us/token of
        tokenizer work inside the device-dispatch loop; here the hot
        loop only appends and notifies, and the SSE reader (asyncio
        thread) or finish() does the decoding."""
        with self.lock:
            self.tokens.append(token_id)
        self._notify()

    def _decode_segment(self, i: int, j: int, final: bool) -> Tuple[str, int]:
        """Decode tokens[i:j] -> (text to emit, new decoded_upto).

        U+FFFD means the trailing byte sequence is incomplete: hold back
        at most 3 tail tokens until more arrive (an incomplete UTF-8
        codepoint spans a few tokens at most; a longer-pending U+FFFD is
        genuinely invalid bytes — emit rather than stalling the stream
        until finish())."""
        piece = self.tokenizer.decode(self.tokens[i:j])
        if final or not piece.endswith("�"):
            return piece, j
        for kk in range(1, min(3, j - i) + 1):
            head = self.tokenizer.decode(self.tokens[i : j - kk])
            if not head.endswith("�"):
                return head, j - kk
        if j - i >= 4:
            return piece, j
        return "", i

    def _drain(self, final: bool = False):
        """Turn undecoded tokens into text pieces (caller holds the lock).

        Reasoning markers toggle the flag in token order and are excluded
        from the text; between markers whole pending segments decode in
        one tokenizer call."""
        toks = self.tokens
        n = len(toks)
        i = self._decoded_upto
        markers = {self.rs_token_id, self.re_token_id} - {None}
        while i < n:
            if toks[i] in markers:
                self.in_reasoning = toks[i] == self.rs_token_id
                i += 1
                continue
            j = i
            while j < n and toks[j] not in markers:
                j += 1
            if self.force_full_seq_decode:
                # sentencepiece-style: re-decode the whole sequence, emit
                # the diff (reference: async_response.py
                # force_full_seq_decode); trailing U+FFFD waits for more
                # tokens (and never emits, matching the reference)
                text = self.tokenizer.decode(toks[:j])
                if not text.endswith("�") and len(text) > self._emitted_chars:
                    self.strs.append(
                        (text[self._emitted_chars :], self.in_reasoning)
                    )
                    self._emitted_chars = len(text)
                i = j
                continue
            piece, upto = self._decode_segment(i, j, final or j < n)
            if piece:
                self.strs.append((piece, self.in_reasoning))
            if upto <= i:
                break  # tail held back; wait for more tokens
            i = upto
            if upto < j:
                break  # held-back incomplete tail
        self._decoded_upto = i

    def finish(self):
        with self.lock:
            self._drain(final=True)
            self.finished = True
        self._notify()

    async def __aiter__(self) -> AsyncIterator[Tuple[str, bool]]:
        self._bind_loop()
        emitted = 0
        while True:
            with self.lock:
                self._drain(final=self.finished)
                seen = len(self.tokens)  # tokens covered by this drain
                chunk = self.strs[emitted:]
                done = self.finished
            for piece in chunk:
                yield piece
            emitted += len(chunk)
            if done and emitted >= len(self.strs):
                return
            self.event.clear()
            with self.lock:
                # re-check without sleeping ONLY when something new
                # arrived since the drain (finish, fresh pieces, or fresh
                # tokens); a held-back incomplete UTF-8 tail keeps
                # _decoded_upto < len(tokens) and must NOT busy-spin the
                # event loop — the next add_data sets the event
                if (
                    self.finished
                    or len(self.strs) > emitted
                    or len(self.tokens) != seen
                ):
                    continue
            await self.event.wait()

    @property
    def num_tokens(self) -> int:
        with self.lock:
            return len(self.tokens)

    def full_text(self) -> Tuple[str, str]:
        """(content, reasoning_content) over the whole stream."""
        with self.lock:
            self._drain(final=self.finished)
            content = "".join(s for s, r in self.strs if not r)
            reasoning = "".join(s for s, r in self.strs if r)
        return content, reasoning


class AsyncResponse:
    """OpenAI-style response formatter (reference: async_response.py:90-167)."""

    def __init__(self, req):
        self.req = req
        self.id = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        self.created = int(time.time())
        self.model = req.model

    async def stream_generator(self) -> AsyncIterator[str]:
        """SSE chunks for `stream=true`."""
        first = True
        async for piece, is_reasoning in self.req.async_stream:
            delta = {"role": "assistant"} if first else {}
            first = False
            if is_reasoning:
                delta["reasoning_content"] = piece
            else:
                delta["content"] = piece
            chunk = {
                "id": self.id,
                "object": "chat.completion.chunk",
                "created": self.created,
                "model": self.model,
                "choices": [
                    {"index": 0, "delta": delta, "finish_reason": None}
                ],
            }
            yield f"data: {json.dumps(chunk)}\n\n"
        usage = self._usage()
        final = {
            "id": self.id,
            "object": "chat.completion.chunk",
            "created": self.created,
            "model": self.model,
            "choices": [
                {"index": 0, "delta": {}, "finish_reason": self.req.finish_reason}
            ],
            "usage": usage,
        }
        yield f"data: {json.dumps(final)}\n\n"
        yield "data: [DONE]\n\n"

    async def full_response(self) -> dict:
        """Complete JSON body for `stream=false`."""
        await self.req.completed.wait()
        content, reasoning = self.req.async_stream.full_text()
        message = {"role": "assistant", "content": content}
        if reasoning:
            message["reasoning_content"] = reasoning
        return {
            "id": self.id,
            "object": "chat.completion",
            "created": self.created,
            "model": self.model,
            "choices": [
                {
                    "index": 0,
                    "message": message,
                    "finish_reason": self.req.finish_reason,
                }
            ],
            "usage": self._usage(),
        }

    def _usage(self) -> dict:
        prompt = self.req.prompt_len
        completion = self.req.async_stream.num_tokens
        return {
            "prompt_tokens": prompt,
            "completion_tokens": completion,
            "total_tokens": prompt + completion,
        }
