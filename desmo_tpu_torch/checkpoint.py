"""Checkpoints: ``.npz`` run state, ``.pt`` export in the reference's key
scheme, and weights carried over from the JAX package.

Port of ``save_state``, ``load_state``, ``load_pt``, ``infer_spec_dims``,
``state_dict_from_params`` and ``params_from_state_dict`` from
``desmo_tpu/checkpoint.py`` (desmo and Fourier variants; the AE variant's
keys through ``models.autoencoder``).
``save_state`` writes the same flat keys as the JAX package
(``params/<key>``, ``opt/count``, ``opt/mu/<key>``, ``opt/nu/<key>``,
``sched/lrs``, ``sched/best``, ``sched/num_bad``, ``epoch``), so
``desmo_tpu.checkpoint.load_state`` reads the port's files and
:func:`load_state` the JAX package's; the ``.pt`` files read back through
``desmo_tpu.checkpoint.load_pt`` and ``torch.load``, and :func:`load_pt`
reads the JAX package's ``.pt`` files and the reference's.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from desmo_tpu_torch import library, optim
from desmo_tpu_torch.models import autoencoder
from desmo_tpu_torch.train import TrainState

_TRIG = ("sin", "cos", "tanh")


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def state_dict_from_params(
    params: Mapping[str, torch.Tensor], variant: str = "desmo"
) -> dict[str, torch.Tensor]:
    """The reference's ``ParameterList`` key scheme (``phi_list.0``,
    ``c_coef``, ``z_list.*``, ``zsin_list.*``, ``sin_coef_list.*``,
    ``omega_list.{3i+k}``, ...), as contiguous CPU tensors. The Fourier
    variant's ``z_list.{t}`` hold the 2nF+1 series coefficients, and it adds
    ``period_list.{t}`` and ``trig_period_list.{3i+k}``, each of shape (1,).
    The AE variant writes the reference ``SINDyAutoencoder``'s keys
    (``autoencoder.state_dict_from_params``)."""
    if variant == "ae":
        return autoencoder.state_dict_from_params(params)
    p = {k: v.detach().cpu() for k, v in params.items()}
    r = p["phi"].shape[0]
    sd: dict[str, torch.Tensor] = {}
    for i in range(r):
        sd[f"phi_list.{i}"] = p["phi"][i]
    sd["c_coef"] = p["c"]
    for t in range(p["z"].shape[0]):
        sd[f"z_list.{t}"] = p["z"][t]
    for kind_idx, kind in enumerate(_TRIG):
        for i in range(r):
            sd[f"z{kind}_list.{i}"] = p["z_trig"][kind_idx, i]
    for kind_idx, kind in enumerate(_TRIG):
        for i in range(r):
            sd[f"{kind}_coef_list.{i}"] = p["c_trig"][kind_idx, i]
    for i in range(r):
        for k in range(3):
            sd[f"omega_list.{3 * i + k}"] = p["omega"][k, i]
    if variant == "fourier":
        for t in range(p["period"].shape[0]):
            sd[f"period_list.{t}"] = p["period"][t : t + 1]
        for i in range(r):
            for k in range(3):
                sd[f"trig_period_list.{3 * i + k}"] = p["trig_period"][k, i].reshape(1)
    return {k: v.contiguous().clone() for k, v in sd.items()}


def params_from_state_dict(
    sd: Mapping, device: torch.device | str, variant: str = "desmo"
) -> dict[str, torch.Tensor]:
    """Inverse of :func:`state_dict_from_params`; values may be tensors or arrays."""
    if variant == "ae":
        return autoencoder.params_from_state_dict(sd, device)

    def collect(prefix: str) -> np.ndarray:
        items = []
        while f"{prefix}.{len(items)}" in sd:
            items.append(_host(sd[f"{prefix}.{len(items)}"]))
        if not items:
            raise KeyError(f"no entries for {prefix!r}")
        return np.stack(items)

    def scalar(key: str) -> float:
        return float(_host(sd[key]).reshape(()))

    phi = collect("phi_list")
    r = phi.shape[0]
    params = {
        "phi": phi,
        "c": _host(sd["c_coef"]),
        "z": collect("z_list"),
        "z_trig": np.stack([collect(f"z{k}_list") for k in _TRIG]),
        "c_trig": np.array([[scalar(f"{k}_coef_list.{i}") for i in range(r)] for k in _TRIG]),
        # omega_list[3i+k] -> omega[k, i]
        "omega": np.array([scalar(f"omega_list.{j}") for j in range(3 * r)]).reshape(r, 3).T,
    }
    if variant == "fourier":
        params["period"] = collect("period_list").reshape(-1)
        # trig_period_list[3i+k] -> trig_period[k, i]
        params["trig_period"] = np.array([scalar(f"trig_period_list.{j}") for j in range(3 * r)]).reshape(r, 3).T
    return params_from_jax(params, device)


def params_from_jax(np_params: Mapping[str, np.ndarray], device: torch.device | str) -> dict[str, torch.Tensor]:
    """The JAX package's parameters (as numpy arrays, same keys and shapes:
    any variant's flat dict, the Fourier variant's ``period`` and the AE
    variant's ``ae_enc_w{i}``/``ae_dec_b{i}`` included, with or without a
    leading seed axis) as the port's float32 tensors on ``device``, in the
    same key order."""
    return {
        k: torch.as_tensor(np.array(v, dtype=np.float32), device=device)
        for k, v in np_params.items()
    }


def state_from_jax(np_state, device: torch.device | str) -> TrainState:
    """The JAX package's ``train.TrainState`` (``params``, ``opt.count``,
    ``opt.mu``, ``opt.nu``, ``sched.lrs``, ``sched.best``, ``sched.num_bad``,
    ``epoch``; leaves as numpy arrays) as the port's :class:`TrainState` on
    ``device``, so both packages can start from the same mid-run state. A
    stacked ensemble state (``desmo_tpu.ensemble.init_state``: a leading
    seed axis on every leaf, ``sched.lrs`` (S, G), ``best`` and ``num_bad``
    (S,)) keeps its shapes."""
    opt, sched = np_state.opt, np_state.sched

    def f32(v):
        return torch.as_tensor(np.array(v, dtype=np.float32), device=device)

    return TrainState(
        params=params_from_jax(np_state.params, device),
        mu=params_from_jax(opt.mu, device),
        nu=params_from_jax(opt.nu, device),
        count=int(np.asarray(opt.count)),
        sched=optim.PlateauState(
            lrs=f32(sched.lrs),
            best=f32(sched.best),
            num_bad=torch.as_tensor(np.array(sched.num_bad, dtype=np.int32), device=device),
        ),
        epoch=int(np.asarray(np_state.epoch)),
    )


def save_pt(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    """``torch.save`` of a state dict of CPU tensors."""
    torch.save(dict(state_dict), path)


def load_pt(path: str) -> dict[str, torch.Tensor]:
    """A ``.pt`` state dict as CPU tensors: ``torch.load`` with
    ``weights_only=True`` (no code in the file runs). Anything but a dict
    raises ``ValueError``."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise ValueError(f"expected a state_dict-like dict, got {type(obj)}")
    return obj


def infer_spec_dims(sd: Mapping) -> tuple[int, int]:
    """(r, poly_order) of a desmo or Fourier state dict in the reference's
    key scheme: r is the number of ``phi_list.*`` masks and poly_order
    follows from ``len(c_coef)`` = C(r + P, P). The reference trains
    different ranks per experiment, so inference sizes the model from the
    checkpoint, not the preset."""
    r = sum(1 for k in sd if k.startswith("phi_list."))
    if r == 0:
        raise ValueError("state dict has no phi_list.* keys (AE checkpoint?)")
    T = int(_host(sd["c_coef"]).reshape(-1).shape[0])
    for P in range(1, 13):
        if library.num_poly_terms(r, P) == T:
            return r, P
    raise ValueError(f"no poly_order matches r={r}, len(c_coef)={T}")


def _flat_state(state: TrainState) -> dict:
    """The state's leaves by their flat key (JAX package keys), tensors as
    they are and the counters as numpy int32."""
    flat = {f"params/{k}": v for k, v in state.params.items()}
    flat["opt/count"] = np.asarray(state.count, np.int32)
    flat.update({f"opt/mu/{k}": v for k, v in state.mu.items()})
    flat.update({f"opt/nu/{k}": v for k, v in state.nu.items()})
    flat["sched/lrs"] = state.sched.lrs
    flat["sched/best"] = state.sched.best
    flat["sched/num_bad"] = state.sched.num_bad
    flat["epoch"] = np.asarray(state.epoch, np.int32)
    return flat


def save_state(path: str, state: TrainState) -> None:
    """Write the full training state to a flat ``.npz`` (JAX package keys)."""
    np.savez(path, **{k: _host(v) for k, v in _flat_state(state).items()})


def load_state(path: str, template: TrainState) -> TrainState:
    """The training state saved at ``path`` by :func:`save_state` or by
    ``desmo_tpu.checkpoint.save_state``; ``template`` (an initialised state
    of the same shapes, e.g. ``train.init_state(params, cfg)``) gives the
    keys, each tensor's dtype and the device. A key of the template missing
    from the file raises ``KeyError``."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    keys = _flat_state(template)
    missing = sorted(set(keys) - set(flat))
    if missing:
        raise KeyError(f"checkpoint missing keys: {missing}")
    device = next(iter(template.params.values())).device

    def tensor(key: str, like: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(np.asarray(flat[key]), device=device).to(like.dtype).reshape(like.shape)

    def tree(prefix: str, like: dict) -> dict:
        return {k: tensor(f"{prefix}/{k}", v) for k, v in like.items()}

    sched = template.sched
    return TrainState(
        params=tree("params", template.params),
        mu=tree("opt/mu", template.mu),
        nu=tree("opt/nu", template.nu),
        count=int(flat["opt/count"]),
        sched=optim.PlateauState(
            lrs=tensor("sched/lrs", sched.lrs), best=tensor("sched/best", sched.best),
            num_bad=tensor("sched/num_bad", sched.num_bad),
        ),
        epoch=int(flat["epoch"]),
    )
