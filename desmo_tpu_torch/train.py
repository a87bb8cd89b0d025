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
non-finite loss, prints the reference-format epoch lines and calls
``checkpoint_fn`` on its cadence. Steps/s leave out the first chunk, which
pays for the kernels' build and the allocator's warm-up.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from desmo_tpu_torch import optim
from desmo_tpu_torch.configs import GROUP_ORDER, RunConfig

LossFn = Callable[[dict, dict], tuple[torch.Tensor, dict]]
"""(params, batch) -> (total_loss, metrics dict with 'rec', 'ortho', 'l1')."""

ChunkFn = Callable[["TrainState", dict, int], tuple["TrainState", dict]]
"""(state, batch, num_steps) -> (state, metrics dict of (num_steps,) tensors)."""

METRICS = ("rec", "ortho", "l1", "total")


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


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    history: dict[str, np.ndarray]  # per-epoch metrics
    steps_per_sec: float
    wall_seconds: float
    # max |omega*latent| the chunk reported (the mega-kernel does); 0.0 when
    # the chunk reports none
    max_abs_trig_arg: float = 0.0


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
) -> TrainResult:
    """Run, or resume from ``state``, ``num_epochs`` (default
    ``cfg.num_epochs``) epochs of training.

    ``chunk(state, batch, num_steps) -> (state, metrics)`` runs one chunk of
    epochs; the default is the eager loop (:func:`make_train_chunk`), and
    ``kernels.train_chunk.select_chunk`` gives the mega-kernel's. A chunk's
    ``max_arg`` metric (max |omega*latent| per epoch) is taken out of the
    history into ``TrainResult.max_abs_trig_arg``. ``checkpoint_fn(state,
    epoch)`` runs every ``cfg.checkpoint_every`` epochs and after the last
    one, at chunk boundaries. A non-finite loss at the end of a chunk raises
    ``FloatingPointError``."""
    num_epochs = cfg.num_epochs if num_epochs is None else num_epochs
    if state is None:
        state = init_state(params, cfg)
    if num_epochs <= 0:
        return TrainResult(state=state, history={}, steps_per_sec=float("nan"), wall_seconds=0.0)
    chunk_size = chunk_size or min(cfg.checkpoint_every, num_epochs)
    train_chunk = chunk or make_train_chunk(loss_fn, group_of, cfg)

    histories: list[dict] = []
    max_abs_trig_arg = 0.0
    start_epoch = state.epoch
    end_epoch = start_epoch + num_epochs
    t0 = None  # starts after the first chunk
    first_chunk = 0
    done = start_epoch
    while done < end_epoch:
        n = min(chunk_size, end_epoch - done)
        state, metrics = train_chunk(state, batch, n)
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
        if checkpoint_fn is not None and (done % cfg.checkpoint_every == 0 or done == end_epoch):
            checkpoint_fn(state, done)
    wall = time.perf_counter() - t0
    steps_timed = done - start_epoch - first_chunk
    sps = steps_timed / wall if wall > 0 and steps_timed > 0 else float("nan")
    history = {k: np.concatenate([h[k] for h in histories]) for k in histories[0]}
    return TrainResult(
        state=state, history=history, steps_per_sec=sps, wall_seconds=wall,
        max_abs_trig_arg=max_abs_trig_arg,
    )
