"""Generation server with dynamic batching into a fixed ladder of batch
sizes (a copy of uce_tpu/serving/server.py for the port's pipelines).

The reference has no serving story: every eval script re-loads the pipeline
per invocation (evalscripts/generate-images-sd.py:13-15). This server loads
once and keeps the card busy:

- a FIXED SET of serving batch sizes, chosen at startup and warmed before
  the first request is accepted (the first batch of each size pays the
  kernel builds and cuBLAS/cuDNN algorithm selection): one batch size by
  default, or a ladder of them (``ServerConfig.batch_sizes``) so
  sub-saturation traffic runs a small batch instead of padding into the
  largest one;
- dynamic batching INTO those sizes: requests queue, a batcher thread
  gathers up to the largest rung (waiting at most ``max_wait_ms`` once the
  first request of a batch arrives), pads up to the smallest rung that
  fits, runs the pipeline once, and fans results back out;
- requests that the pipeline family cannot honour are rejected up front.

All torch work happens on the single batcher thread; submit() is
thread-safe and returns a Future.

Spans (``utils/observability``): ``serve.idle`` while the batcher waits on
an empty queue, ``serve.fill`` while it waits out ``max_wait_ms`` for
stragglers, ``serve.batch`` around each batch (the parent of the pipeline's
spans) and, per request, ``serve.queue`` from submit() to the start of its
batch. ``ServerStats`` sums the queue and fill waits at the same bounds.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from uce_tpu_torch.diffusion.sampler import FastConfig
from uce_tpu_torch.utils.observability import record, span

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """The serving batch size(s) and generation settings.

    ``batch_sizes`` (optional) is a LADDER of batch sizes: each gathered
    batch runs the smallest size that fits, so low-rate traffic pays
    batch-1/2 device time instead of padding into the largest batch (a
    padded batch costs the full batch's time whatever its fill). Warmup
    runs every rung once; leave it unset for the classic single-size
    server.

    Determinism caveat: with a ladder, the same (prompt, seed) can land
    on different rungs across arrivals. Different batch sizes may pick
    different cuBLAS/cuDNN algorithms, whose sums differ by a few ULPs,
    which can cross a uint8 rounding boundary — so repeated submissions of
    one request may differ by ±1 level per pixel depending on traffic.
    ``pin_rung=True`` removes the caveat: every batch pads into the TOP
    rung, so one batch shape serves all traffic (bit-reproducible outputs
    per (prompt, seed), at the cost of the ladder's low-rate latency win —
    use it for reproducibility-sensitive evals). The single-size server
    (empty ``batch_sizes``) never has the caveat.

    ``fast`` is a ``FastConfig.from_spec`` spec (CFG window, DeepCache),
    opt-in beyond the reference protocol, passed to every batch; a pipeline
    family whose call takes no ``fast`` fails start().
    """

    batch_size: int = 4
    num_inference_steps: int = 50
    guidance_scale: float = 7.5
    height: int = 512
    width: int = 512
    scheduler: str | None = None
    max_wait_ms: float = 50.0
    warmup: bool = True
    batch_sizes: tuple = ()  # () -> (batch_size,)
    pin_rung: bool = False
    fast: str | None = None


@dataclasses.dataclass
class Request:
    prompt: str
    seed: int
    negative_prompt: str = ""
    future: Future = dataclasses.field(default_factory=Future)
    id: int = 0
    submitted_ns: int | None = None  # perf_counter_ns at submit(); None: warm-up


@dataclasses.dataclass
class ServerStats:
    batches: int = 0
    requests: int = 0
    padded_slots: int = 0
    total_batch_seconds: float = 0.0
    queue_wait_seconds: float = 0.0  # summed over requests: submit() to their batch's start
    fill_wait_seconds: float = 0.0  # waiting out max_wait_ms with a batch begun

    @property
    def occupancy(self) -> float:
        filled = self.requests
        total = self.requests + self.padded_slots
        return filled / total if total else 0.0


class GenerationServer:
    """Dynamic-batching front end over a pipeline's fixed serving shapes.

    ``pipe`` is any pipeline called with (prompt list, seed list,
    num_inference_steps, guidance_scale, num_images_per_prompt, height,
    width) that returns uint8 [N, H, W, 3]: SDPipeline, which also takes
    scheduler, negative_prompt and fast; HiDreamPipeline, which takes
    negative_prompt and fast (a CFG window only: the pipeline raises on a
    cache interval, at warm-up or in a batch, as in uce_tpu); or FluxPipeline, which takes none of them (the
    server adapts to the call's signature).
    """

    def __init__(self, pipe, config: ServerConfig = ServerConfig()):
        self.pipe = pipe
        self.config = config
        # the batch ladder, ascending; _run_batch picks the smallest rung
        # that fits the gathered requests
        self.batch_sizes = tuple(sorted(set(
            config.batch_sizes or (config.batch_size,))))
        if any(s < 1 for s in self.batch_sizes):
            raise ValueError("batch sizes must be >= 1")
        self._fast = None
        if config.fast:
            self._fast = FastConfig.from_spec(config.fast)
            if self._fast.is_noop:
                self._fast = None
        self.stats = ServerStats()
        self._queue: queue.Queue[Request | None] = queue.Queue()
        self._thread: threading.Thread | None = None
        self._closed = False
        self._lock = threading.Lock()  # orders submit() against close()
        self._request_ids = itertools.count(1)
        self._batch_ids = itertools.count(1)
        self._pipe_param_names = self._inspect_pipe_params()

    def _inspect_pipe_params(self) -> frozenset | None:
        """Parameter names of the pipeline's call signature, or None when
        it takes **kwargs (accepts everything). Computed once — the
        pipeline is fixed for the server's lifetime."""
        import inspect

        try:
            params = inspect.signature(self.pipe.__call__).parameters
        except (TypeError, ValueError):
            return None
        if any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params.values()):
            return None
        return frozenset(params)

    def _pipe_supports(self, name: str) -> bool:
        return self._pipe_param_names is None or \
            name in self._pipe_param_names

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "GenerationServer":
        # static config errors must fail startup, not every future batch
        if self.config.scheduler is not None and \
                not self._pipe_supports("scheduler"):
            raise ValueError(
                "this pipeline family takes no scheduler override")
        if self._fast is not None and not self._pipe_supports("fast"):
            raise ValueError("this pipeline family takes no fast config")
        if self.config.warmup:
            t0 = time.perf_counter()
            # largest rung first: an out-of-memory fails startup before
            # the cheap rungs waste warm-up time; a pinned server only
            # ever runs the top rung, so skip warming the others
            warm_sizes = (self.batch_sizes[-1:] if self.config.pin_rung
                          else tuple(reversed(self.batch_sizes)))
            for size in warm_sizes:
                self._run_batch(
                    [Request(prompt="", seed=0) for _ in range(size)])
            logger.info("serving signature(s) warmed in %.1f s "
                        "(batches=%s %dx%d steps=%d)",
                        time.perf_counter() - t0, list(self.batch_sizes),
                        self.config.height, self.config.width,
                        self.config.num_inference_steps)
            # warmup batches do not count toward serving stats
            self.stats = ServerStats()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="uce-batcher")
        self._thread.start()
        return self

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)
        alive = False
        if self._thread is not None:
            self._thread.join(timeout=600)
            alive = self._thread.is_alive()
        # fail any request that raced past the sentinel instead of leaving
        # its Future pending forever
        drained = []
        while True:
            try:
                drained.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for req in drained:
            if req is not None and not req.future.done():
                req.future.set_exception(RuntimeError("server is closed"))
        if alive and None in drained:
            # join timed out with the batcher still inside a batch and the
            # drain stole its shutdown sentinel — give it back, or the
            # batcher blocks forever in _gather once it finishes
            self._queue.put(None)

    def __enter__(self) -> "GenerationServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- client surface -----------------------------------------------

    def submit(self, prompt: str, seed: int = 0,
               negative_prompt: str = "") -> Future:
        """Enqueue one generation; the Future resolves to uint8 [H, W, 3].

        A request the pipeline family cannot honor is rejected HERE so it
        cannot poison the other requests in its batch."""
        if negative_prompt and not self._pipe_supports("negative_prompt"):
            raise ValueError(
                "this pipeline family takes no negative prompts")
        req = Request(prompt=prompt, seed=int(seed),
                      negative_prompt=negative_prompt, id=next(self._request_ids),
                      submitted_ns=time.perf_counter_ns())
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._queue.put(req)
        return req.future

    def generate(self, prompt: str, seed: int = 0,
                 negative_prompt: str = "") -> np.ndarray:
        return self.submit(prompt, seed, negative_prompt).result()

    # -- batcher ------------------------------------------------------

    def _gather(self) -> list[Request] | None:
        """Block for the first request, then collect up to batch_size,
        waiting at most max_wait_ms for stragglers."""
        with span("serve.idle"):
            first = self._queue.get()
        if first is None:
            return None
        batch = [first]
        with span("serve.fill") as fill:
            deadline = time.monotonic() + self.config.max_wait_ms / 1000.0
            while len(batch) < self.batch_sizes[-1]:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._queue.put(None)  # re-post shutdown for the loop
                    break
                batch.append(nxt)
        self.stats.fill_wait_seconds += (fill.t1 - fill.t0) / 1e9
        return batch

    def _pipe_kwargs(self, negatives: list[str]) -> dict:
        """Adapt to the pipeline family's call signature: a family may take
        no scheduler override or negative prompts (SD takes both).
        Unsupported non-default values were already rejected at
        start()/submit()."""
        cfg = self.config
        out = {}
        if self._pipe_supports("scheduler"):
            out["scheduler"] = cfg.scheduler
        if self._pipe_supports("negative_prompt"):
            out["negative_prompt"] = negatives
        if self._fast is not None:
            out["fast"] = self._fast
        return out

    def _run_batch(self, batch: list[Request]) -> None:
        # drop requests whose Future was cancelled by the client; calling
        # set_result on them would raise and poison their batchmates
        batch = [r for r in batch
                 if r.future.set_running_or_notify_cancel()]
        if not batch:
            return
        cfg = self.config
        n_real = len(batch)
        # smallest rung that fits (gather never exceeds the top); pin_rung
        # always pads into the top rung so one batch shape serves all
        # traffic (bit-reproducible per request across occupancies)
        size = self.batch_sizes[-1] if cfg.pin_rung else \
            next(s for s in self.batch_sizes if s >= n_real)
        n_pad = size - n_real
        prompts = [r.prompt for r in batch] + [""] * n_pad
        seeds = [r.seed for r in batch] + [0] * n_pad
        negatives = [r.negative_prompt for r in batch] + [""] * n_pad
        batch_id = next(self._batch_ids)
        warmup = all(r.submitted_ns is None for r in batch)  # start()'s, never submitted
        with span("serve.batch", getattr(self.pipe, "device", None), batch=batch_id,
                  n_real=n_real, n_pad=n_pad, warmup=warmup) as run:
            for r in batch:
                if r.submitted_ns is not None:
                    record("serve.queue", r.submitted_ns, run.t0, request=r.id, batch=batch_id)
                    self.stats.queue_wait_seconds += (run.t0 - r.submitted_ns) / 1e9
            t0 = time.perf_counter()
            images = self.pipe(
                prompts,
                num_inference_steps=cfg.num_inference_steps,
                guidance_scale=cfg.guidance_scale,
                num_images_per_prompt=1,
                seed=seeds,
                height=cfg.height,
                width=cfg.width,
                **self._pipe_kwargs(negatives),
            )
            dt = time.perf_counter() - t0
        self.stats.batches += 1
        self.stats.requests += n_real
        self.stats.padded_slots += n_pad
        self.stats.total_batch_seconds += dt
        for i, req in enumerate(batch):
            req.future.set_result(np.asarray(images[i]))

    def _loop(self) -> None:
        while True:
            batch = self._gather()
            if batch is None:
                return
            try:
                self._run_batch(batch)
            except Exception as exc:  # fan the failure out, keep serving
                logger.exception("batch failed")
                for req in batch:
                    if not req.future.done():
                        req.future.set_exception(exc)
