"""Autoencoder-latent DESMO: learned spatial modes instead of POD masks.
Port of ``desmo_tpu/models/autoencoder.py``.

Each spatial point's time series (a row of X, length m) is encoded by an MLP
m->256->128->64->16->8->4->2 with ReLU, so the 2-dim latent per point forms
two learned spatial modes (n, 2); a mirrored decoder gives an auxiliary
reconstruction, trained with an extra ``ae_beta * MSE`` term.

Kept from the reference, as the JAX package keeps them:

* the tanh channel is computed but left out of the reconstruction sum, so
  its parameters stay at their init;
* the tanh coefficients are left out of the L1 term;
* per-channel omega inits: sin 1e4, cos 1e3, tanh 1e2 times
  ``omega_init / 1e4``;
* the orthogonality loss is ``MSE(phi1 phi2ᵀ, 0) = ||phi1||² ||phi2||² / n²``.

Parameters are a flat dict in the JAX package's keys and order
(``ae_enc_w{i}``/``ae_enc_b{i}``, ``ae_dec_w{i}``/``ae_dec_b{i}`` with
weights (in, out), then ``c``, ``z``, ``z_trig``, ``c_trig``, ``omega``).
The random inits draw from a ``torch.Generator`` seeded with the run's seed:
the same distributions as the JAX package's, not its bits. Every product
runs in full fp32 (``device.fp32_matmul``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from desmo_tpu_torch import library, losses
from desmo_tpu_torch.kernels import dual_gemm
from desmo_tpu_torch.models import desmo as desmo_model

Params = dict[str, torch.Tensor]

ENCODER_WIDTHS = (256, 128, 64, 16, 8, 4)  # hidden layers; the latent r follows
N_LAYERS = len(ENCODER_WIDTHS) + 1  # layers per side


@dataclasses.dataclass(frozen=True)
class AESpec(desmo_model.DesmoSpec):
    """r=2, poly_order=2 in the reference run."""

    include_tanh: bool = False  # the reference leaves tanh out of the sum


def layer_widths(spec: AESpec) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(encoder widths m..r, decoder widths r..m)."""
    enc = (spec.m, *ENCODER_WIDTHS, spec.r)
    return enc, enc[::-1]


def _check_r(spec: AESpec) -> None:
    if spec.r != 2:
        raise ValueError("the AE variant is defined for r=2 latent modes")


class AE(nn.Module):
    """AE-DESMO parameters: Xavier-uniform MLP weights with zero biases, the
    library parameters all ones and omega per channel, as the reference
    initialises them. The keys come in the JAX package's order."""

    def __init__(self, spec: AESpec, seed: int = 43, device: torch.device | str = "cpu"):
        super().__init__()
        _check_r(spec)
        T, r, m = spec.num_poly_terms, spec.r, spec.m
        gen = torch.Generator().manual_seed(int(seed))
        enc, dec = layer_widths(spec)
        for prefix, widths in (("ae_enc", enc), ("ae_dec", dec)):
            for i in range(N_LAYERS):
                fi, fo = widths[i], widths[i + 1]
                bound = float(np.sqrt(6.0 / (fi + fo)))
                w = (torch.rand((fi, fo), generator=gen) * 2.0 - 1.0) * bound
                self.register_parameter(f"{prefix}_w{i}", nn.Parameter(w.to(device)))
                self.register_parameter(f"{prefix}_b{i}", nn.Parameter(torch.zeros(fo, device=device)))
        f32 = dict(dtype=torch.float32, device=device)
        self.c = nn.Parameter(torch.ones((T,), **f32))
        self.z = nn.Parameter(torch.ones((T, m), **f32))
        self.z_trig = nn.Parameter(torch.ones((3, r, m), **f32))
        self.c_trig = nn.Parameter(torch.ones((3, r), **f32))
        # sin 1e4, cos 1e3, tanh 1e2 at omega_init=1e4; the 1 : 0.1 : 0.01
        # channel ratio is kept for other omega_init values
        channel = torch.tensor([[1e4, 1e4], [1e3, 1e3], [1e2, 1e2]], **f32)
        self.omega = nn.Parameter((spec.omega_init / 1e4) * channel)

    def params(self) -> Params:
        return dict(self.named_parameters())


def init_params(spec: AESpec, seed: int = 43, device: torch.device | str = "cpu") -> Params:
    """The reference init as a detached params dict."""
    return {k: v.detach() for k, v in AE(spec, seed, device).params().items()}


def init_params_live(spec: AESpec, seed: int = 43, bias: float = 0.01,
                     device: torch.device | str = "cpu") -> Params:
    """He-normal MLP weights and +``bias`` hidden biases (the last layer of
    each side keeps a zero bias): the init leg of the AE recipe. The
    reference's Xavier/zero-bias funnel has an exactly dead decoder, whose
    every MLP weight gets a zero gradient; this one keeps the units alive.
    The library parameters are those of :func:`init_params`."""
    params = init_params(spec, seed, device)
    gen = torch.Generator().manual_seed(int(seed) + 1000)
    enc, dec = layer_widths(spec)
    for prefix, widths in (("ae_enc", enc), ("ae_dec", dec)):
        for i in range(N_LAYERS):
            fi, fo = widths[i], widths[i + 1]
            w = torch.randn((fi, fo), generator=gen) * float(np.sqrt(2.0 / fi))
            params[f"{prefix}_w{i}"] = w.to(device)
            if i < N_LAYERS - 1:
                params[f"{prefix}_b{i}"] = torch.full((fo,), bias, dtype=torch.float32, device=device)
    return params


def _mlp(params: Params, prefix: str, x: torch.Tensor) -> torch.Tensor:
    for i in range(N_LAYERS):
        x = x @ params[f"{prefix}_w{i}"] + params[f"{prefix}_b{i}"]
        if i < N_LAYERS - 1:
            x = torch.relu(x)
    return x


def encode_decode(params: Params, x_nm: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(latent (n, r), auxiliary reconstruction (n, m)) of the rows of X."""
    latent = _mlp(params, "ae_enc", x_nm)
    return latent, _mlp(params, "ae_dec", latent)


@torch.no_grad()
def data_scaled_omega(params: Params, x_nm: torch.Tensor, ratio=(1.0, 0.1, 0.01)) -> torch.Tensor:
    """Omega (3, r) from the current latent RMS: the reference's
    1 : 0.1 : 0.01 sin/cos/tanh ratio with the sin argument O(1) in any data
    units (``RunConfig.ae_omega_data_scaled``, ``--ae-data-omega``)."""
    latent, _ = encode_decode(params, x_nm)
    rms = torch.clamp(torch.sqrt(torch.mean(latent * latent, dim=0)), min=1e-12)
    return torch.as_tensor(ratio, dtype=latent.dtype, device=latent.device)[:, None] / rms[None, :]


def build_warmup_loss(spec: AESpec):
    """The recipe's warmup objective, ``MSE(decode(encode(X)), X)`` alone,
    with the joint loss' metric keys; the dictionary gets zero gradient."""

    def loss_fn(params: Params, batch: dict):
        _, ae_rec = encode_decode(params, batch["x"])
        m = losses.mse(ae_rec, batch["x"])
        zero = torch.zeros((), dtype=m.dtype, device=m.device)
        return m, {"rec": m, "ortho": zero, "l1": zero, "ae": m}

    return loss_fn


def dictionary(params: Params, latent: torch.Tensor, spec: AESpec, factors: torch.Tensor) -> torch.Tensor:
    """A (n, T + 3r): the c-scaled library and the coefficient-scaled trig
    terms of the latent, the tanh channel masked out of the sum unless
    ``spec.include_tanh``."""
    theta = library.eval_library(latent, factors) * params["c"][None, :]
    basis = desmo_model.trig_basis(latent, params["omega"])  # (3, r, n)
    mask = torch.tensor([1.0, 1.0, 1.0 if spec.include_tanh else 0.0], device=latent.device)
    g = (mask[:, None, None] * params["c_trig"][:, :, None] * basis).reshape(-1, latent.shape[0]).T
    return torch.cat([theta, g], dim=1)


def apply(params: Params, x_nm: torch.Tensor, spec: AESpec, factors: torch.Tensor | None = None):
    """``(recon (n, m), latent (n, r), z (T, m), ae_rec (n, m))``."""
    if factors is None:
        factors = desmo_model.factor_tensor(spec, x_nm.device)
    latent, ae_rec = encode_decode(params, x_nm)
    A = dictionary(params, latent, spec, factors)
    return A @ desmo_model.temporal_matrix(params), latent, params["z"], ae_rec


def ae_orthogonality(latent: torch.Tensor) -> torch.Tensor:
    """``MSE(phi1 phi2ᵀ, 0) = ||phi1||² ||phi2||² / n²``."""
    n = latent.shape[0]
    return torch.sum(latent[:, 0] ** 2) * torch.sum(latent[:, 1] ** 2) / (n * n)


def ae_sparsity_l1(params: Params) -> torch.Tensor:
    """|c| plus the sin and cos coefficients; tanh left out."""
    ct = params["c_trig"]
    return params["c"].abs().sum() + ct[0].abs().sum() + ct[1].abs().sum()


def factored_ae_mse(params: Params, latent: torch.Tensor, x: torch.Tensor, batch: dict) -> torch.Tensor:
    """``MSE(decoder(latent), X)`` without the (n, m) decode: with H the last
    hidden activation (n, 256), W, b the last layer and 1 the ones row,

        ||H W + 1 b - X||² = <HᵀH, W Wᵀ> - 2 <HᵀX, W> + 2 (1ᵀH W)·b
                             - 2 (1ᵀX)·b + n ||b||² + ||X||².

    ``batch['x_sq']`` and ``batch['x_colsum']`` are used when present."""
    h = latent
    for i in range(N_LAYERS - 1):
        h = torch.relu(h @ params[f"ae_dec_w{i}"] + params[f"ae_dec_b{i}"])
    W, b = params[f"ae_dec_w{N_LAYERS - 1}"], params[f"ae_dec_b{N_LAYERS - 1}"]
    n, m = x.shape
    x_sq = batch.get("x_sq")
    if x_sq is None:
        x_sq = torch.sum(x * x)
    xcol = batch.get("x_colsum")
    if xcol is None:
        xcol = torch.sum(x, dim=0)
    sh = torch.sum(h, dim=0)
    sq = (
        torch.sum((h.T @ h) * (W @ W.T))
        - 2.0 * torch.sum((h.T @ x) * W)
        + x_sq
        + 2.0 * torch.dot(sh @ W, b)
        - 2.0 * torch.dot(xcol, b)
        + n * torch.dot(b, b)
    )
    return sq / (n * m)


LOSS_METHODS = ("factored", "fused", "naive", "direct")


def build_loss(spec: AESpec, beta: float, l1_lambda: float, ae_beta: float, method: str = "factored"):
    """``total = MSE + beta ortho + l1_lambda L1 + ae_beta MSE(ae_rec, X)``;
    ``batch = {'x': X (n, m)[, 'x_sq', 'x_colsum']}``. The dictionary MSE is
    factored (``losses.factored_mse``), fused (the dual-contraction kernel)
    or materialized (``naive``/``direct``); the AE-MSE is factored except
    under ``naive``, which keeps the materialized decode, as in the JAX
    package. Metrics ``rec``, ``ortho``, ``l1``, ``ae``."""
    if method not in LOSS_METHODS:
        raise ValueError(f"unknown loss method {method!r}")
    _check_r(spec)
    by_device: dict[torch.device, torch.Tensor] = {}

    def loss_fn(params: Params, batch: dict):
        x = batch["x"]
        factors = by_device.get(x.device)
        if factors is None:
            factors = by_device[x.device] = desmo_model.factor_tensor(spec, x.device)
        latent = _mlp(params, "ae_enc", x)
        A = dictionary(params, latent, spec, factors)
        B = desmo_model.temporal_matrix(params)
        x_sq = batch.get("x_sq")
        if method == "fused":
            if x_sq is None:
                x_sq = torch.sum(x * x)
            rec = dual_gemm.factored_mse_fused(A, B, x, x_sq)
        elif method == "factored":
            rec = losses.factored_mse(A, B, x, x_sq)
        else:
            rec = losses.mse(A @ B, x)
        if method == "naive":
            ae = losses.mse(_mlp(params, "ae_dec", latent), x)
        else:
            ae = factored_ae_mse(params, latent, x, batch)
        ortho = ae_orthogonality(latent)
        l1 = ae_sparsity_l1(params)
        total = rec + beta * ortho + l1_lambda * l1 + ae_beta * ae
        return total, {"rec": rec, "ortho": ortho, "l1": l1, "ae": ae}

    return loss_fn


def param_group(key: str) -> str:
    """omega -> 'omega'; c and c_trig -> 'coef'; z, z_trig and every MLP
    tensor -> 'z' (the reference's default group)."""
    if key == "omega":
        return "omega"
    if key in ("c", "c_trig"):
        return "coef"
    return "z"


def param_groups(params: Params) -> dict[str, str]:
    return {k: param_group(k) for k in params}


# --- the reference's state-dict interchange ----------------------------------

_SCALAR_KEYS = {
    # state-dict name -> (params key, index)
    "sin_coef_1": ("c_trig", (0, 0)),
    "sin_coef_2": ("c_trig", (0, 1)),
    "cos_coef_1": ("c_trig", (1, 0)),
    "cos_coef_2": ("c_trig", (1, 1)),
    "tanh_coef_1": ("c_trig", (2, 0)),
    "tanh_coef_2": ("c_trig", (2, 1)),
    "omega_phi1": ("omega", (0, 0)),  # sin phi1
    "omega_phi2": ("omega", (1, 0)),  # cos phi1
    "omega_phi3": ("omega", (0, 1)),  # sin phi2
    "omega_phi4": ("omega", (1, 1)),  # cos phi2
    "omega_phi5": ("omega", (2, 0)),  # tanh phi1
    "omega_phi6": ("omega", (2, 1)),  # tanh phi2
}

_VECTOR_KEYS = {
    "zsin_coef_1": (0, 0),
    "zsin_coef_2": (0, 1),
    "zcos_coef_1": (1, 0),
    "zcos_coef_2": (1, 1),
    "ztanh_coef_1": (2, 0),
    "ztanh_coef_2": (2, 1),
}


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def is_ae_state_dict(sd) -> bool:
    """True when the state dict holds the reference ``SINDyAutoencoder``'s MLP keys."""
    return any(k.startswith("temporal_ae.") for k in sd)


def infer_spec_dims(sd) -> tuple[int, int]:
    """(r, poly_order) of an AE state dict: r is the last encoder layer's
    width, poly_order follows from ``len(c_coef)`` = C(r + P, P)."""
    last = 2 * len(ENCODER_WIDTHS)
    r = int(_host(sd[f"temporal_ae.encoder.{last}.weight"]).shape[0])
    T = int(_host(sd["c_coef"]).reshape(-1).shape[0])
    for P in range(1, 13):
        if library.num_poly_terms(r, P) == T:
            return r, P
    raise ValueError(f"no poly_order matches r={r}, len(c_coef)={T}")


def params_from_state_dict(sd, device: torch.device | str = "cpu") -> Params:
    """Import a reference ``SINDyAutoencoder`` state dict: its Linear
    weights are (out, in) and ours (in, out); ``Sequential`` indices
    0, 2, 4, ... are the layers (the ReLUs hold no parameters)."""
    out: dict[str, np.ndarray] = {}
    for i in range(N_LAYERS):
        for side in ("encoder", "decoder"):
            p = "enc" if side == "encoder" else "dec"
            out[f"ae_{p}_w{i}"] = _host(sd[f"temporal_ae.{side}.{2 * i}.weight"]).T
            out[f"ae_{p}_b{i}"] = _host(sd[f"temporal_ae.{side}.{2 * i}.bias"])
    ordered = {k: out[k] for k in [f"ae_enc_{w}{i}" for i in range(N_LAYERS) for w in "wb"]
               + [f"ae_dec_{w}{i}" for i in range(N_LAYERS) for w in "wb"]}
    ordered["c"] = _host(sd["c_coef"])
    T = ordered["c"].shape[0]
    ordered["z"] = np.stack([_host(sd[f"z_list.{t}"]) for t in range(T)])
    m = ordered["z"].shape[1]
    z_trig = np.ones((3, 2, m), np.float32)
    for name, idx in _VECTOR_KEYS.items():
        z_trig[idx] = _host(sd[name])
    ordered["z_trig"] = z_trig
    c_trig = np.ones((3, 2), np.float32)
    omega = np.ones((3, 2), np.float32)
    for name, (key, idx) in _SCALAR_KEYS.items():
        (c_trig if key == "c_trig" else omega)[idx] = float(_host(sd[name]).reshape(()))
    ordered["c_trig"] = c_trig
    ordered["omega"] = omega
    return {k: torch.as_tensor(np.array(v, dtype=np.float32), device=device) for k, v in ordered.items()}


def state_dict_from_params(params: Params) -> dict[str, torch.Tensor]:
    """The reference's ``SINDyAutoencoder`` keys (``temporal_ae.encoder.{2i}.weight``
    (out, in), ``c_coef``, ``z_list.{t}``, ``zsin_coef_1``, ``sin_coef_1``,
    ``omega_phi1``, ...) as contiguous CPU tensors."""
    p = {k: v.detach().cpu() for k, v in params.items()}
    sd: dict[str, torch.Tensor] = {}
    for i in range(N_LAYERS):
        sd[f"temporal_ae.encoder.{2 * i}.weight"] = p[f"ae_enc_w{i}"].T
        sd[f"temporal_ae.encoder.{2 * i}.bias"] = p[f"ae_enc_b{i}"]
        sd[f"temporal_ae.decoder.{2 * i}.weight"] = p[f"ae_dec_w{i}"].T
        sd[f"temporal_ae.decoder.{2 * i}.bias"] = p[f"ae_dec_b{i}"]
    sd["c_coef"] = p["c"]
    for t in range(p["z"].shape[0]):
        sd[f"z_list.{t}"] = p["z"][t]
    for name, idx in _VECTOR_KEYS.items():
        sd[name] = p["z_trig"][idx]
    for name, (key, idx) in _SCALAR_KEYS.items():
        sd[name] = p[key][idx]
    return {k: v.contiguous().clone() for k, v in sd.items()}
