"""OpenAI-compatible HTTP serving layer (aiohttp).

Counterpart of `chitu_tpu/serve.py` (reference: chitu/serve.py:1-237):
`/v1/chat/completions` (streaming SSE + full JSON), `/ping` `/health`
`/status` `/load_status` for load balancers, admission rejection on
overload (403), engine warmup before serving, a worker thread driving the
engine loop, and quiet access logs for probe endpoints.

aiohttp and pydantic are imported only when a server is built, so the
engine and the rest of the package run without them.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import time
from collections import deque
from typing import List, Optional, Union

from chitu_tpu_torch.async_response import AsyncResponse
from chitu_tpu_torch.config import EngineConfig, load_config
from chitu_tpu_torch.engine import Engine, EngineState
from chitu_tpu_torch.task import SampleParams, TaskLoad
from chitu_tpu_torch.utils import get_logger

logger = get_logger()


_CHAT_REQUEST = None


def chat_request_model():
    """The request schema (reference: serve.py:45-53), built on first use
    so that pydantic is needed only by a running server; out-of-range
    sampling fields reject like the OpenAI contract."""
    global _CHAT_REQUEST
    if _CHAT_REQUEST is not None:
        return _CHAT_REQUEST
    from pydantic import BaseModel, Field, field_validator

    class ChatMessage(BaseModel):
        role: str
        content: str

    class ChatRequest(BaseModel):
        messages: Union[str, List[ChatMessage]]
        model: Optional[str] = None
        temperature: float = Field(1.0, ge=0.0, le=10.0)
        top_p: float = Field(0.9, gt=0.0, le=1.0)
        top_k: int = Field(-1, ge=-1)

        @field_validator("top_k")
        @classmethod
        def _clamp_top_k(cls, v: int) -> int:
            # the sampler draws from the top MAX_K logits (sampling.py):
            # clamp here with a log so the API behavior is visible
            from chitu_tpu_torch.sampling import MAX_K

            if v > MAX_K:
                logger.warning(
                    "top_k=%d exceeds the sampler's candidate set "
                    "(MAX_K=%d); clamping", v, MAX_K,
                )
                return MAX_K
            return v

        frequency_penalty: float = Field(0.0, ge=-2.0, le=2.0)
        stream: bool = False
        max_tokens: Optional[int] = Field(None, ge=1)
        # scheduler weight for the stride policy (reference:
        # scheduler.py:189-235)
        priority: float = Field(1.0, gt=0.0)

    _CHAT_REQUEST = ChatRequest
    return ChatRequest


class ServerContext:
    """Engine + worker-thread lifecycle shared by the endpoints."""

    def __init__(self, cfg: EngineConfig, device=None):
        self.cfg = cfg
        self.device = device
        self.engine: Optional[Engine] = None
        self.worker: Optional[threading.Thread] = None
        self.stop_flag = threading.Event()
        self.wake = threading.Event()
        # admission-curve state (serve.admission_max_wait_s): completion
        # timestamps over a sliding window estimate the service rate
        self.done_times: "deque[float]" = deque(maxlen=512)
        self.shed_count = 0

    def note_done(self):
        self.done_times.append(time.time())

    def completion_rate(self, window_s: float = 10.0) -> float:
        """Requests completed per second over the trailing window."""
        now = time.time()
        n = sum(1 for t in self.done_times if now - t <= window_s)
        return n / window_s

    def start(self, warmup: bool = True):
        self.engine = Engine(self.cfg, device=self.device)
        if warmup:
            warmup_engine(self.engine)
        self.stop_flag.clear()
        self.worker = threading.Thread(target=self._worker_loop, daemon=True)
        self.worker.start()

    def _worker_loop(self):
        """Busy loop running engine steps whenever work exists
        (reference: serve.py:167-176)."""
        while not self.stop_flag.is_set():
            if self.engine is not None and len(self.engine.pool):
                try:
                    self.engine.step()
                except Exception:
                    logger.exception("engine step failed")
                    time.sleep(0.05)
            else:
                self.wake.wait(timeout=0.005)
                self.wake.clear()

    def stop(self):
        self.stop_flag.set()
        if self.worker is not None:
            # terminate() mutates allocator/sampler state the running
            # step also touches, so NEVER run it concurrently
            self.worker.join(timeout=60)
            if self.worker.is_alive():
                logger.error(
                    "worker still stepping after 60s; skipping terminate"
                )
                return
        if self.engine is not None:
            self.engine.terminate()


def warmup_engine(engine: Engine):
    """Run a burst and a lone request through the engine before traffic
    arrives (reference: serve.py:183-212), then seed the adaptive-window
    cost model from timed decode windows. Eager PyTorch has no compile
    sweep to do, so the JAX package's per-bucket sweep is not needed."""
    t0 = time.time()
    cfg = engine.cfg
    n = cfg.infer.max_reqs
    for _ in range(n):
        engine.submit(
            "warmup " * 4, SampleParams(temperature=0.0, max_new_tokens=4)
        )
    engine.run_until_complete()
    engine.generate("warmup", SampleParams(temperature=0.0, max_new_tokens=2))
    if cfg.infer.adaptive_window:
        engine.executor.calibrate_dispatch()
    logger.info("warmup done in %.1fs (%d reqs)", time.time() - t0, n)


def _json_error(status: int, detail: str):
    from aiohttp import web

    return web.json_response({"detail": detail}, status=status)


def build_app(ctx: ServerContext):
    from aiohttp import web
    from pydantic import ValidationError

    ChatRequest = chat_request_model()
    app = web.Application()

    async def create_chat_completion(request):
        engine = ctx.engine
        if engine is None or engine.state != EngineState.RUNNING:
            return _json_error(503, "engine not running")
        # admission control (reference: serve.py:61-67)
        if TaskLoad.get_num_reqs() >= 4 * ctx.cfg.infer.max_reqs:
            ctx.shed_count += 1
            return _json_error(403, "engine overloaded")
        # predicted-wait admission curve (VERDICT r4 next-6: past the
        # knee, queueing converts throughput into TTFT — shed instead):
        # queued requests / observed completion rate estimates this
        # request's wait; beyond the SLO it is better served by a retry
        # against another replica (the /load_status contract)
        slo = ctx.cfg.serve.admission_max_wait_s
        if slo > 0:
            queued = max(
                0, TaskLoad.get_num_reqs() - ctx.cfg.infer.max_reqs
            )
            rate = ctx.completion_rate()
            # no completions observed yet (cold start): only the hard
            # cap applies — shedding on a zero estimate would refuse the
            # very first burst
            shed = (
                queued / rate > slo
                if rate > 0.0
                else queued > ctx.cfg.infer.max_reqs
            )
            if queued > 0 and shed:
                ctx.shed_count += 1
                return _json_error(
                    403,
                    f"admission SLO exceeded (queued={queued}, "
                    f"rate={rate:.1f}/s)",
                )
        try:
            body = ChatRequest.model_validate(await request.json())
        except (ValidationError, json.JSONDecodeError) as e:
            return _json_error(422, str(e))
        params = SampleParams(
            temperature=body.temperature,
            top_p=body.top_p,
            top_k=body.top_k,
            frequency_penalty=body.frequency_penalty,
            max_new_tokens=(
                body.max_tokens
                if body.max_tokens is not None
                else ctx.cfg.request.max_new_tokens
            ),
        )
        message = (
            body.messages
            if isinstance(body.messages, str)
            else [{"role": m.role, "content": m.content} for m in body.messages]
        )
        try:
            # tokenization runs off the event loop: a huge prompt would
            # otherwise freeze every in-flight SSE stream and health probe
            req = await asyncio.get_running_loop().run_in_executor(
                None,
                lambda: engine.submit(message, params, priority=body.priority),
            )
            # submit ran on an executor thread where bind_loop() finds no
            # running loop; re-bind HERE so finish() wakes the awaiting
            # coroutine via call_soon_threadsafe (a plain Event.set from
            # the worker thread never wakes an already-waiting await)
            req.bind_loop()
        except ValueError as e:
            return _json_error(400, str(e))
        ctx.wake.set()
        resp_fmt = AsyncResponse(req)
        try:
            if body.stream:
                sse = web.StreamResponse(
                    status=200,
                    headers={
                        "Content-Type": "text/event-stream",
                        "Cache-Control": "no-cache",
                    },
                )
                await sse.prepare(request)
                async for chunk in resp_fmt.stream_generator():
                    await sse.write(chunk.encode())
                await sse.write_eof()
                return sse
            return web.json_response(await resp_fmt.full_response())
        finally:
            # client gone before completion: stop generating (a dropped
            # stream would otherwise decode to max_tokens, burning device
            # time and KV pages that block live admissions)
            if req.finish_reason is None:
                engine.cancel(req.request_id)
            ctx.note_done()  # feeds the admission curve's service rate

    async def ping(_):
        return web.json_response({"message": "pong"})

    async def health(_):
        ok = ctx.engine is not None and ctx.engine.state == EngineState.RUNNING
        return web.json_response(
            {"status": "ok" if ok else "down"}, status=200 if ok else 503
        )

    async def status(_):
        eng = ctx.engine
        body = {
            "engine": eng.state.name if eng else "absent",
            "model": ctx.cfg.models.name,
            "live_tasks": len(eng.pool) if eng else 0,
            # known structurally-slow layouts (engine.degraded_paths):
            # operators should see these without reading bring-up logs
            "degraded_paths": list(getattr(eng, "degraded", []) or [])
            if eng
            else [],
        }
        if eng is not None and ctx.cfg.infer.adaptive_window:
            body["adaptive_window"] = {
                "kappa": round(eng.executor._kappa, 3),
                "kappa_src": eng.executor._kappa_src,
            }
        alloc = eng.cache.allocator if eng else None
        if alloc is not None and hasattr(alloc, "hits"):
            body["prefix_cache"] = {
                "page_hits": alloc.hits,
                "page_misses": alloc.misses,
                "cached_pages": len(alloc.entries),
            }
        # engine-phase timers (VERDICT r4 weak-7: the serving-vs-engine
        # gap needs a checked-in breakdown): cumulative seconds + call
        # counts per phase since boot, plus admission shedding
        from chitu_tpu_torch.utils import get_timers

        body["timers"] = {
            name: {"s": round(t.elapsed_, 3), "n": t.count}
            # snapshot: the engine worker thread adds timers concurrently
            for name, t in list(get_timers().timers.items())
        }
        body["admission"] = {
            "shed": ctx.shed_count,
            "completion_rate": round(ctx.completion_rate(), 2),
        }
        if eng is not None:
            # KV pressure at a glance (kv_pool_frac deployments live here)
            body["kv"] = {
                "free_pages": eng.cache.allocator.num_free(),
                "total_pages": eng.cache.num_pages,
            }
        return web.json_response(body)

    async def load_status(_):
        """Load-balancer endpoint (reference: serve.py:137-143)."""
        return web.json_response(
            {
                "load": TaskLoad.get_load(),
                "num_reqs": TaskLoad.get_num_reqs(),
                "max_reqs": ctx.cfg.infer.max_reqs,
            }
        )

    async def stop(_):
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, ctx.stop)
        return web.json_response({"message": "stopped"})

    async def init(request):
        """(Re)build the engine from config overrides
        (reference: serve.py /init endpoint)."""
        if ctx.engine is not None and ctx.engine.state == EngineState.RUNNING:
            return _json_error(409, "engine already running")
        try:
            body = await request.json() if request.can_read_body else {}
        except json.JSONDecodeError:
            body = {}
        overrides = body.get("overrides", [])
        loop = asyncio.get_running_loop()

        def boot():
            ctx.cfg = load_config(overrides=overrides)
            ctx.start(warmup=body.get("warmup", False))

        await loop.run_in_executor(None, boot)
        return web.json_response({"message": "initialized"})

    app.router.add_post("/v1/chat/completions", create_chat_completion)
    app.router.add_get("/ping", ping)
    app.router.add_get("/health", health)
    app.router.add_get("/status", status)
    app.router.add_get("/load_status", load_status)
    app.router.add_post("/stop", stop)
    app.router.add_post("/init", init)
    return app


class BackgroundServer:
    """Run the app in a background thread on an ephemeral port (tests,
    embedded usage, benchmark drivers)."""

    def __init__(self, cfg: EngineConfig, warmup: bool = False, device=None):
        self.ctx = ServerContext(cfg, device=device)
        self.warmup = warmup
        self.port: Optional[int] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()

    def start(self) -> int:
        from aiohttp import web

        self.ctx.start(warmup=self.warmup)
        app = build_app(self.ctx)
        self._loop = asyncio.new_event_loop()

        def run():
            asyncio.set_event_loop(self._loop)

            async def boot():
                runner = web.AppRunner(app)
                await runner.setup()
                site = web.TCPSite(runner, "127.0.0.1", self.ctx.cfg.serve.port)
                await site.start()
                self.port = site._server.sockets[0].getsockname()[1]
                self._started.set()

            self._loop.run_until_complete(boot())
            self._loop.run_forever()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=60):
            raise RuntimeError("server failed to start")
        return self.port

    def stop(self):
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.ctx.stop()


class _ProbeFilter(logging.Filter):
    """Silence access logs for probe endpoints (reference: serve.py:156-164)."""

    def filter(self, record: logging.LogRecord) -> bool:
        msg = record.getMessage()
        return "/ping" not in msg and "/load_status" not in msg


def serve_forever(cfg: EngineConfig, warmup: bool = True, device=None):
    from aiohttp import web

    ctx = ServerContext(cfg, device=device)
    ctx.start(warmup=warmup)
    logging.getLogger("aiohttp.access").addFilter(_ProbeFilter())
    app = build_app(ctx)
    logger.info("serving on %s:%d", cfg.serve.host, cfg.serve.port)
    web.run_app(
        app, host=cfg.serve.host, port=cfg.serve.port, print=None
    )
    ctx.stop()


def main(argv: Optional[List[str]] = None):
    """`python -m chitu_tpu_torch key=value ...` (reference hydra entry:
    serve.py:215-218); serves on the CUDA device."""
    import sys

    overrides = list(argv if argv is not None else sys.argv[1:])
    cfg = load_config(overrides=overrides)
    serve_forever(cfg)


if __name__ == "__main__":
    main()
