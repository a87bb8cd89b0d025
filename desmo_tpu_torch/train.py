"""The chunked eager training loop. Port of ``desmo_tpu/train.py``.

Training is full-batch, so one optimizer step is one epoch. Each epoch runs,
in the order of ``desmo_tpu.train.make_train_chunk``:

1. the loss and metrics of the pre-update parameters, and their gradient;
2. Adamax on one packed parameter vector, with per-element learning rates
   gathered from the group-LR tensor and the bias ``1 - b1^t``;
3. the plateau scheduler, stepped with the pre-update total when
   ``epoch % sched_every == 0``.

Epochs run in chunks of the contract ``chunk(state, batch, num_steps) ->
(state, metrics)`` of ``desmo_tpu/train.py``: the eager loop here
(:func:`make_train_chunk`) or the mega-kernel
(``kernels.train_chunk.fused_train_chunk``). A chunk's metrics stay on the
device and are fetched once at its end, where the loop checks for a
non-finite loss, prints the reference-format epoch lines and hands
``checkpoint_fn`` a host copy of the state on its cadence, to write on a
worker thread while the next chunk runs. Steps/s leave out the first chunk,
which pays for the kernels' build and the allocator's warm-up.

Graceful preemption (``desmo_tpu/train.py:46-100``): SIGTERM, through
:func:`install_preemption_handler`, or :func:`request_preemption` raises a
latch; the running :func:`fit` stops at its next chunk boundary with a
final checkpoint and ``TrainResult.preempted``, and resuming from that
state gives the uninterrupted run's bits.
"""

from __future__ import annotations

import dataclasses
import signal
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import wait as futures_wait
from typing import Callable, Optional

import numpy as np
import torch

from desmo_tpu_torch import optim, parallel, profiling
from desmo_tpu_torch.configs import GROUP_ORDER, RunConfig

LossFn = Callable[[dict, dict], tuple[torch.Tensor, dict]]
"""(params, batch) -> (total_loss, metrics dict with 'rec', 'ortho', 'l1')."""

ChunkFn = Callable[["TrainState", dict, int], tuple["TrainState", dict]]
"""(state, batch, num_steps) -> (state, metrics dict of (num_steps,) tensors)."""

METRICS = ("rec", "ortho", "l1", "total")

_PREEMPT = threading.Event()


def request_preemption() -> None:
    """Ask the running :func:`fit` (or ``ensemble.fit``) to stop at its next
    chunk boundary, after a final checkpoint. Safe from a signal handler and
    from other threads. The fit that honours the request clears it, so one
    request stops one fit."""
    _PREEMPT.set()


def preemption_requested() -> bool:
    return _PREEMPT.is_set()


def clear_preemption() -> None:
    _PREEMPT.clear()


def preemption_agreed(device_mesh=None) -> bool:
    """Whether a preemption was requested here or, over ``device_mesh``, on
    any rank (one MAX all-reduce, so that every rank stops at the same chunk
    boundary)."""
    flag = preemption_requested()
    return flag if device_mesh is None else device_mesh.agree(flag)


def install_preemption_handler(signals=(signal.SIGTERM,)) -> None:
    """Turn ``signals`` (SIGTERM, what SLURM preemption and spot-VM reclaim
    send) into :func:`request_preemption` for this process, chaining any
    handler installed before. Main thread only (CPython's rule for
    ``signal.signal``); the CLI installs it, library callers opt in."""
    for sig in signals:
        prev = signal.getsignal(sig)

        def handler(signum, frame, prev=prev):
            request_preemption()
            if callable(prev):
                prev(signum, frame)

        signal.signal(sig, handler)


_CKPT_POOL: Optional[ThreadPoolExecutor] = None


def _ckpt_pool() -> ThreadPoolExecutor:
    """The one worker that writes checkpoints, in the order they were handed
    to it. It touches only host memory: it never launches a kernel nor
    joins a collective."""
    global _CKPT_POOL
    if _CKPT_POOL is None:
        _CKPT_POOL = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
    return _CKPT_POOL


@dataclasses.dataclass
class TrainState:
    params: dict[str, torch.Tensor]
    mu: dict[str, torch.Tensor]  # Adamax first moments, like params
    nu: dict[str, torch.Tensor]  # Adamax infinity-norm buffers, like params
    count: int  # Adamax steps taken
    sched: optim.PlateauState
    epoch: int  # epochs already taken


def init_state(params: dict, cfg: RunConfig) -> TrainState:
    """Fresh optimizer and scheduler state around a copy of ``params``."""
    params = {k: v.detach().clone() for k, v in params.items()}
    device = next(iter(params.values())).device
    return TrainState(
        params=params,
        mu={k: torch.zeros_like(v) for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        count=0,
        sched=optim.plateau_init(cfg.group_lrs, device),
        epoch=0,
    )


class FlatLayout:
    """All parameters as one fp32 vector, so the Adamax update is a handful
    of element-wise kernels over the whole vector instead of a set per
    parameter. ``unflatten`` returns views, through which autograd routes
    the gradient back into the vector."""

    def __init__(self, params: dict, group_of: dict[str, str]):
        self.keys = list(params)
        self.shapes = {k: tuple(params[k].shape) for k in self.keys}
        self.sizes = [int(np.prod(self.shapes[k])) for k in self.keys]
        gidx = np.concatenate(
            [np.full(s, GROUP_ORDER.index(group_of[k]), np.int64) for k, s in zip(self.keys, self.sizes)]
        )
        self.group_index = torch.as_tensor(gidx, device=next(iter(params.values())).device)

    def flatten(self, tree: dict) -> torch.Tensor:
        return torch.cat([tree[k].detach().reshape(-1).to(torch.float32) for k in self.keys])

    def unflatten(self, vec: torch.Tensor) -> dict:
        parts = torch.split(vec, self.sizes)
        return {k: p.view(self.shapes[k]) for k, p in zip(self.keys, parts)}


def make_train_chunk(loss_fn: LossFn, group_of: dict[str, str], cfg: RunConfig) -> ChunkFn:
    """The eager chunk: ``chunk(state, batch, num_steps) -> (state, metrics)``
    running ``num_steps`` epochs one PyTorch operation at a time.

    The parameters and both Adamax moments travel as one packed vector each
    inside the chunk; ``metrics`` holds one (num_steps,) device tensor per
    key the loss returns (``METRICS`` for the desmo and Fourier losses, and
    ``ae`` besides for the AE loss), and ``total``."""

    def chunk(state: TrainState, batch: dict, num_steps: int):
        layout = FlatLayout(state.params, group_of)
        vec = layout.flatten(state.params)
        opt = optim.AdamaxState(state.count, layout.flatten(state.mu), layout.flatten(state.nu))
        sched, epoch = state.sched, state.epoch
        rows, keys = [], None
        for _ in range(num_steps):
            leaf = vec.detach().requires_grad_(True)
            total, metrics = loss_fn(layout.unflatten(leaf), batch)
            (grad,) = torch.autograd.grad(total, leaf)
            with torch.no_grad():
                updates, opt = optim.adamax_update(grad, opt, sched.lrs[layout.group_index])
                vec = leaf.detach() + updates
                if epoch % cfg.sched_every == 0:
                    sched = optim.plateau_step(
                        sched, total, patience=cfg.patience,
                        factor=cfg.sched_factor, min_lr=cfg.sched_min_lr,
                    )
                if keys is None:
                    keys = [k for k in metrics if k != "total"] + ["total"]
                rows.append(torch.stack([total if k == "total" else metrics[k] for k in keys]))
            epoch += 1
        out = TrainState(
            layout.unflatten(vec), layout.unflatten(opt.mu), layout.unflatten(opt.nu),
            opt.count, sched, epoch,
        )
        stacked = torch.stack(rows)
        return out, {k: stacked[:, i] for i, k in enumerate(keys)}

    return chunk


def host_snapshot(state: TrainState) -> tuple[TrainState, Optional[torch.cuda.Event]]:
    """A copy of ``state`` in host memory that no later chunk touches, and
    the event after which it holds the state's values. A tensor on the card
    is copied into pinned memory without blocking, on the current stream
    behind the chunk that wrote it and ahead of any later launch; wait on the
    event (``Event.synchronize``, not a launch) before reading. On the CPU
    the copy is done when this returns and the event is None."""
    on_card = False

    def copy(t: torch.Tensor) -> torch.Tensor:
        nonlocal on_card
        if t.device.type != "cuda":
            return t.detach().clone()
        on_card = True
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t.detach(), non_blocking=True)
        return host

    def tree(d: dict) -> dict:
        return {k: copy(v) for k, v in d.items()}

    sched = state.sched
    snap = TrainState(
        tree(state.params), tree(state.mu), tree(state.nu), state.count,
        optim.PlateauState(copy(sched.lrs), copy(sched.best), copy(sched.num_bad)), state.epoch,
    )
    event = None
    if on_card:
        event = torch.cuda.Event()
        event.record()
    return snap, event


def _write_checkpoint(checkpoint_fn, held: list, epoch: int, parent=None, go=None) -> None:
    """Span ``ckpt.write`` of ``held``'s host copy (``[snap, event]`` of
    :func:`host_snapshot`; the caller frees it), in span ``parent`` (the
    ``fit.checkpoint`` that handed it over), once ``go`` (a
    ``threading.Event``), when given, is set."""
    snap, event = held
    if go is not None:
        go.wait()
    with profiling.span("ckpt.write", parent=parent):
        if event is not None:
            event.synchronize()
        checkpoint_fn(snap, epoch)
    profiling.count("ckpt.writes")


class CheckpointWriter:
    """A fit's checkpoints, written by the checkpoint worker
    (:func:`_ckpt_pool`) while the fit goes on, one at a time and in the
    order they were handed over.

    :meth:`hand_off` takes a host copy of a whole state (:func:`host_snapshot`:
    on the card, copies queued behind the chunk that wrote it and ahead of
    the next launch), waits for the previous write (counter ``ckpt.waits``
    when it was still running) and submits this one, which starts at
    :meth:`launched`: once the fit has enqueued its next chunk and waits on
    the card, so that the write, mostly Python, does not hold the
    interpreter lock while the fit sets that launch up. The host copy and
    its event are freed on the fit's thread once written: freeing them
    makes CUDA calls, which on the worker stalled it behind the fit's wait
    on the card for up to two chunks. :meth:`poll` raises a write that
    failed; :meth:`drain` waits for the last write, span ``fit.drain``, and
    raises it if it failed. As a context manager it also waits for the last
    write when an exception leaves the block, so that no ``checkpoint_fn``
    runs after the fit has ended."""

    def __init__(self, checkpoint_fn: Callable[[TrainState, int], None]):
        self._checkpoint_fn = checkpoint_fn
        self._pending: Optional[Future] = None
        self._go: Optional[threading.Event] = None  # the pending write's start
        self._held: list = []  # the pending write's host copy and event

    def __enter__(self) -> CheckpointWriter:
        return self

    def __exit__(self, exc_type, *exc) -> bool:
        if exc_type is not None and self._pending is not None:
            self.launched()
            futures_wait([self._pending])  # the exception in flight wins over the write's own
        self._held.clear()
        return False

    def hand_off(self, state: TrainState, epoch: int) -> None:
        """Write ``state`` (whole: over a mesh, gathered by the caller) as
        epoch ``epoch``'s checkpoint, in span ``fit.checkpoint`` when the
        caller opened one."""
        snap, event = host_snapshot(state)
        if self._pending is not None:
            self.launched()
            if not self._pending.done():
                profiling.count("ckpt.waits")
            self._pending.result()  # keeps the writes in order; raises a failed one
        self._held.clear()
        self._held = [snap, event]
        self._go = threading.Event()
        self._pending = _ckpt_pool().submit(
            _write_checkpoint, self._checkpoint_fn, self._held, epoch, profiling.current(), self._go)

    def launched(self) -> None:
        """Let the handed-off write start: call after each chunk call."""
        if self._go is not None:
            self._go.set()
            self._go = None

    def poll(self) -> None:
        """Raise the last write's failure, if it has ended."""
        if self._pending is not None and self._pending.done():
            pending, self._pending = self._pending, None
            pending.result()

    def drain(self) -> None:
        """Wait for the last write; raise its failure."""
        if self._pending is not None:
            self.launched()
            pending, self._pending = self._pending, None
            with profiling.span("fit.drain"):
                pending.result()
            self._held.clear()


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    history: dict[str, np.ndarray]  # per-epoch metrics
    steps_per_sec: float
    # max |omega*latent| the chunk reported (the mega-kernel does); 0.0 when
    # the chunk reports none
    max_abs_trig_arg: float = 0.0
    # stopped early at a chunk boundary on a preemption request
    preempted: bool = False


@profiling.traced("fit")
def fit(
    loss_fn: LossFn,
    group_of: dict[str, str],
    cfg: RunConfig,
    params: dict,
    batch: dict,
    num_epochs: Optional[int] = None,
    chunk_size: Optional[int] = None,
    log: Optional[Callable[[str], None]] = print,
    checkpoint_fn: Optional[Callable[[TrainState, int], None]] = None,
    *,
    state: Optional[TrainState] = None,
    chunk: Optional[ChunkFn] = None,
    device_mesh=None,
) -> TrainResult:
    """Run, or resume from ``state``, ``num_epochs`` (default
    ``cfg.num_epochs``) epochs of training.

    ``chunk(state, batch, num_steps) -> (state, metrics)`` runs one chunk of
    epochs; the default is the eager loop (:func:`make_train_chunk`), and
    ``kernels.train_chunk.select_chunk`` gives the mega-kernel's. A chunk's
    ``max_arg`` metric (max |omega*latent| per epoch) is taken out of the
    history into ``TrainResult.max_abs_trig_arg``. A non-finite loss at the
    end of a chunk raises ``FloatingPointError``.

    ``checkpoint_fn(state, epoch)`` runs every ``cfg.checkpoint_every``
    epochs and after the last one, at chunk boundaries: the loop takes the
    whole state (over ``device_mesh``, whose ranks hold phi's rows, it
    gathers them with ``parallel.gather_state`` on this thread, since that is
    a collective), takes a host copy of it
    (:func:`host_snapshot`) and hands that to the checkpoint worker
    (:class:`CheckpointWriter`), whose thread calls ``checkpoint_fn`` while
    the next chunk runs. Writes keep their order; a failed write raises at
    the next chunk boundary or at the end. Every write has ended when fit
    returns or raises. A preemption request that stops fit before its first
    chunk writes the incoming state on this thread.

    The call is span ``fit``; each boundary's parts are spans ``fit.launch``,
    ``fit.fetch``, ``fit.log`` and ``fit.checkpoint``, and the wait on the
    last write ``fit.drain`` (``profiling``).

    A preemption request (:func:`request_preemption`, the SIGTERM handler)
    stops the loop at the next chunk boundary with a final checkpoint and
    ``preempted=True``; one already raised when fit starts stops it before
    the first chunk, the incoming state checkpointed. The request is then
    cleared. A request taken at the last boundary reports ``preempted=True``
    too, so that a caller with more work to do (the period multi-start's
    next probe) sees it; ``desmo_tpu.train.fit`` reports it only when epochs
    are left. Over ``device_mesh`` the ranks agree on the request at each
    boundary by one MAX all-reduce, so that all stop at the same one; every
    rank then passes a ``checkpoint_fn`` (a no-op where it writes nothing),
    so that each joins the gather."""
    num_epochs = cfg.num_epochs if num_epochs is None else num_epochs
    if state is None:
        state = init_state(params, cfg)
    if num_epochs <= 0:
        return TrainResult(state=state, history={}, steps_per_sec=float("nan"))
    chunk_size = chunk_size or min(cfg.checkpoint_every, num_epochs)
    train_chunk = chunk or make_train_chunk(loss_fn, group_of, cfg)

    def whole(st: TrainState) -> TrainState:
        return st if device_mesh is None else parallel.gather_state(st, device_mesh, cfg.n)

    if preemption_agreed(device_mesh):
        # raised before this fit started (e.g. during an earlier warmup that
        # passed it on): stop before the first chunk, saving the incoming
        # state, which may hold that earlier phase's unsaved work
        if checkpoint_fn is not None:
            with profiling.span("fit.checkpoint"):
                _write_checkpoint(checkpoint_fn, list(host_snapshot(whole(state))), state.epoch, profiling.current())
        if log is not None:
            saved = "incoming state checkpointed" if checkpoint_fn is not None else "no checkpoint_fn: state NOT saved"
            log(f"graceful preemption: stopped before the first chunk; {saved}")
        clear_preemption()
        return TrainResult(state=state, history={}, steps_per_sec=float("nan"), preempted=True)

    histories: list[dict] = []
    max_abs_trig_arg = 0.0
    start_epoch = state.epoch
    end_epoch = start_epoch + num_epochs
    t0 = None  # starts after the first chunk
    first_chunk = 0
    preempted = False
    done = start_epoch
    with CheckpointWriter(checkpoint_fn) as writer:
        while done < end_epoch:
            n = min(chunk_size, end_epoch - done)
            with profiling.span("fit.launch"):
                state, metrics = train_chunk(state, batch, n)
            writer.launched()
            with profiling.span("fit.fetch"):
                # the chunk's one host sync
                fetched = torch.stack([metrics[k] for k in metrics]).cpu().numpy()
                chunk_metrics = {k: fetched[i] for i, k in enumerate(metrics)}
                max_arg = chunk_metrics.pop("max_arg", None)
                if max_arg is not None:
                    max_abs_trig_arg = max(max_abs_trig_arg, float(np.max(max_arg)))
                if not np.isfinite(chunk_metrics["total"][-1]):
                    bad = int(np.argmax(~np.isfinite(chunk_metrics["total"])))
                    raise FloatingPointError(
                        f"non-finite training loss at epoch {done + bad}; inspect LRs/omega_init"
                    )
                if t0 is None:
                    t0 = time.perf_counter()
                    first_chunk = n
                histories.append(chunk_metrics)
            if log is not None:
                with profiling.span("fit.log"):
                    for i in range(done, done + n):
                        if i % cfg.log_every == 0 or i == end_epoch - 1:
                            j = i - done
                            log(
                                f"Epoch [{i + 1}/{end_epoch}], "
                                f"Rec Loss: {chunk_metrics['rec'][j]:.12f}, "
                                f"Spatial ortho loss: {chunk_metrics['ortho'][j]:.8f}, "
                                f"L1 loss: {chunk_metrics['l1'][j]:.4f} "
                            )
            done += n
            preempt = preemption_agreed(device_mesh)
            writer.poll()  # a failed write raises here, at the next boundary
            if checkpoint_fn is not None and (done % cfg.checkpoint_every == 0 or done == end_epoch or preempt):
                with profiling.span("fit.checkpoint"):
                    writer.hand_off(whole(state), done)
            if preempt:
                if log is not None:
                    saved = "final state checkpointed" if checkpoint_fn is not None else "no checkpoint_fn: state NOT saved"
                    with profiling.span("fit.log"):
                        log(f"graceful preemption: stopped at epoch {done} (of {end_epoch}); {saved}")
                clear_preemption()  # one request stops one fit
                preempted = True
                break
        writer.drain()
    wall = time.perf_counter() - t0
    steps_timed = done - start_epoch - first_chunk
    sps = steps_timed / wall if wall > 0 and steps_timed > 0 else float("nan")
    history = {k: np.concatenate([h[k] for h in histories]) for k in histories[0]}
    return TrainResult(
        state=state, history=history, steps_per_sec=sps, max_abs_trig_arg=max_abs_trig_arg, preempted=preempted,
    )
