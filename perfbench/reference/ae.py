"""Plain PyTorch reference of AE-DESMO training: the initial parameters and
one epoch (forward, loss, gradients by autograd, Adamax, the plateau
scheduler), as ``reference/desmo.py`` has them, with the spatial side of the
autoencoder variant.

It follows the published ``DESMO_AE/DESMO_Cylinder_AE-Final.py`` (the
``SINDyAutoencoder`` model, its loss, optimizer and scheduler), written out
again without the program. Each spatial point's time series, a row of X
(length m), goes through the encoder MLP m->256->128->64->16->8->4->2, ReLU
after every layer but the last; its output is the point's latent (two
learned spatial modes over the n points); the mirrored decoder
2->4->...->256->m, ReLU after every layer but the last, gives an auxiliary
reconstruction of the row. The library is ``reference/desmo.py``'s on that
latent: the polynomial terms times c, then sin and cos of ``omega * latent``
times their coefficients. The script's quirks are kept:

- the tanh channel is computed and left out of the reconstruction's sum and
  out of L1, so its coefficients, its temporal rows and its omega get no
  gradient;
- omega starts per channel at sin 1e4, cos 1e3, tanh 1e2 (times
  ``omega_init / 1e4``);
- ortho is ``MSE(phi1 phi2ᵀ, 0)``, the mean square of the (n, n) outer
  product of the two latent modes;
- every MLP tensor is in the optimizer's default group, with z and z_trig:
  ``lr_z``; c and c_trig take ``lr_coef``, omega ``lr_omega``.

The loss is ``total = rec + beta ortho + lam l1 + ae_beta ae``, with rec and
ae the means of the direct (n, m) residuals ``A B - X`` and ``decoder(latent)
- X`` (the program forms both from Gram products) and l1 the sum of |c| and
of the sin and cos coefficients. Gradients by autograd; Adamax and the
plateau rule are ``reference/desmo.py``'s. Everything runs in float32 with
TF32 off; ``low=True`` rounds every matrix product's operands to TF32, the
MLP's included: the control. It imports nothing of the measured package.

Init: the published Xavier-uniform MLP weights (bound ``sqrt(6 / (fan_in +
fan_out))``) and zero biases, c, z, z_trig and c_trig one. The draws are
``(U[0, 1) * 2 - 1) * bound`` from a CPU ``torch.Generator`` seeded with the
run's seed, one (fan_in, fan_out) draw a weight in the order encoder layers
0..6, then decoder layers 0..6: the published distribution, drawn by a
stated recipe (the script's own draws, under its ``set_seed(43)``, are not
reproduced).

Leaves: ``ae_enc_w{i}`` (in, out), ``ae_enc_b{i}``, ``ae_dec_w{i}``,
``ae_dec_b{i}`` for i = 0..6, ``c`` (T,), ``z`` (T, m), ``z_trig`` (3, r,
m), ``c_trig`` (3, r), ``omega`` (3, r). One model a run: the program packs
no seeds of this variant. The POD modes the harness hands :func:`epoch` and
:func:`loss` are ignored (the program's batch carries X's column sums in
their place); the POD is still computed and compared, as the program
computes it for its error table.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.reference import desmo
from perfbench.reference.desmo import B1, full_fp32, initial_state, matmul, pod_modes  # noqa: F401

ENCODER_WIDTHS = (256, 128, 64, 16, 8, 4)  # hidden layers; the latent r follows
N_LAYERS = len(ENCODER_WIDTHS) + 1  # layers a side
ENCODER_LEAVES = tuple(f"ae_enc_{w}{i}" for i in range(N_LAYERS) for w in "wb")
DECODER_LEAVES = tuple(f"ae_dec_{w}{i}" for i in range(N_LAYERS) for w in "wb")
LEAVES = ENCODER_LEAVES + DECODER_LEAVES + ("c", "z", "z_trig", "c_trig", "omega")
# each leaf's optimizer group, as index into the config's (lr_coef, lr_phi,
# lr_z, lr_omega, lr_period)
GROUP = dict({k: 2 for k in ENCODER_LEAVES + DECODER_LEAVES}, c=0, c_trig=0, z=2, z_trig=2, omega=3)
# the leaves the latents, and so ortho, depend on
LATENT_LEAVES = ENCODER_LEAVES
PERIOD_LEAVES = ()
# no leaf has a row per spatial point: the MLP is shared by every row
ROW_LEAVES = ()
# the latents come from the encoder, not from POD modes
LATENT_FROM_POD = False
# the encoder's and the decoder's first gradients, each measured against its
# own median leaf: at the init they lie 1e1-1e4 and 1e-9-1e-5 in norm, the
# library's 1e-3-2
GRAD_GROUPS = {"grad_encoder": ENCODER_LEAVES, "grad_decoder": DECODER_LEAVES}
# ortho, the product of the latents' squared norms over n², by its relative gap
ORTHO_RELATIVE = True
METRICS = ("rec", "ortho", "l1", "total", "ae")
# sin, cos, tanh omega at omega_init = 1e4
CHANNEL_OMEGA = (1e4, 1e3, 1e2)
KINDS = ("sin", "cos", "tanh")


def widths(m: int, r: int) -> tuple[int, ...]:
    """The encoder's layer widths, m .. r (the decoder's, reversed)."""
    return (m, *ENCODER_WIDTHS, r)


def initial_params(config: dict, seed: int, device) -> dict:
    """The init of the module's docstring, on the CPU, then on ``device``."""
    m, r = config["m"], config["r"]
    gen = torch.Generator().manual_seed(int(seed))
    enc = widths(m, r)
    out: dict = {}
    for prefix, ws in (("ae_enc", enc), ("ae_dec", enc[::-1])):
        for i in range(N_LAYERS):
            fi, fo = ws[i], ws[i + 1]
            bound = float(np.sqrt(6.0 / (fi + fo)))
            out[f"{prefix}_w{i}"] = (torch.rand((fi, fo), generator=gen) * 2.0 - 1.0) * bound
            out[f"{prefix}_b{i}"] = torch.zeros(fo)
    T = len(desmo.monomials(r, config["poly_order"]))
    out.update(
        c=torch.ones(T), z=torch.ones((T, m)), z_trig=torch.ones((3, r, m)), c_trig=torch.ones((3, r)),
        omega=(config["omega_init"] / 1e4) * torch.tensor(CHANNEL_OMEGA)[:, None].repeat(1, r),
    )
    return {k: out[k].to(torch.float32).to(device) for k in LEAVES}


def seed_params(config: dict, n_seeds: int, seed: int, device) -> list[dict]:
    """The initial parameters drawn from ``seed``; the variant trains one
    model a run."""
    if n_seeds != 1:
        raise ValueError(f"the AE variant trains one model a run, not {n_seeds}")
    return [initial_params(config, seed, device)]


def mlp(params: dict, prefix: str, h: torch.Tensor, low: bool) -> torch.Tensor:
    """The encoder (``ae_enc``) or decoder (``ae_dec``) over the rows of h."""
    for i in range(N_LAYERS):
        h = matmul(h, params[f"{prefix}_w{i}"], low) + params[f"{prefix}_b{i}"]
        if i < N_LAYERS - 1:
            h = torch.relu(h)
    return h


def loss(params: dict, x: torch.Tensor, modes: torch.Tensor, config: dict, beta: float, lam: float,
         low: bool = False) -> tuple[torch.Tensor, dict]:
    """The module docstring's total and its terms ``rec``, ``ortho``,
    ``l1``, ``ae``, ``total``; ``modes`` is not used."""
    lat = mlp(params, "ae_enc", x, low)
    n, r = lat.shape
    cols = []
    for term in desmo.monomials(r, config["poly_order"]):
        col = torch.ones_like(lat[:, 0])
        for v in term:
            col = col * lat[:, v]
        cols.append(col)
    theta = torch.stack(cols, dim=1) * params["c"][None, :]
    args = params["omega"][:, :, None] * lat.T[None, :, :]
    trig = [torch.sin(args[0]), torch.cos(args[1]), torch.tanh(args[2])]
    # the tanh channel is computed and left out of the sum
    a = torch.cat([theta] + [(trig[k] * params["c_trig"][k][:, None]).T for k in range(2)], dim=1)
    b = torch.cat([params["z"], params["z_trig"][0], params["z_trig"][1]], dim=0)
    resid = matmul(a, b, low) - x
    rec = torch.mean(resid * resid)
    outer = matmul(lat[:, 0:1], lat[:, 1:2].T, low)
    ortho = torch.mean(outer * outer)
    l1 = torch.abs(params["c"]).sum() + torch.abs(params["c_trig"][0]).sum() + torch.abs(params["c_trig"][1]).sum()
    dec = mlp(params, "ae_dec", lat, low) - x
    ae = torch.mean(dec * dec)
    total = rec + beta * ortho + lam * l1 + config["ae_beta"] * ae
    return total, {"rec": rec, "ortho": ortho, "l1": l1, "total": total, "ae": ae}


def epoch(state: dict, x: torch.Tensor, modes: torch.Tensor, config: dict, beta: float, lam: float,
          low: bool = False) -> tuple[dict, dict, dict]:
    """One epoch of :func:`loss` from ``state`` (``desmo.step`` over
    :data:`LEAVES` in :data:`GROUP`; a leaf out of the loss gets a zero
    gradient)."""
    return desmo.step(state, lambda p: loss(p, x, modes, config, beta, lam, low), config, LEAVES, GROUP)


def pt_params(sd: dict) -> dict:
    """The leaves of an exported ``.pt`` in the published script's
    ``SINDyAutoencoder`` key scheme: ``temporal_ae.{encoder,decoder}.{2i}.
    {weight,bias}`` (each ``Linear``'s weight (out, in)), ``c_coef``,
    ``z_list.t``, ``z{kind}_coef_{j}``, ``{kind}_coef_{j}`` and
    ``omega_phi1..6`` (sin phi1, cos phi1, sin phi2, cos phi2, tanh phi1,
    tanh phi2), as arrays."""
    out = {}
    for side, prefix in (("encoder", "ae_enc"), ("decoder", "ae_dec")):
        for i in range(N_LAYERS):
            out[f"{prefix}_w{i}"] = sd[f"temporal_ae.{side}.{2 * i}.weight"].numpy().T
            out[f"{prefix}_b{i}"] = sd[f"temporal_ae.{side}.{2 * i}.bias"].numpy()
    out["c"] = sd["c_coef"].numpy()
    z = []
    while f"z_list.{len(z)}" in sd:
        z.append(sd[f"z_list.{len(z)}"].numpy())
    out["z"] = np.stack(z)
    r = 2
    out["z_trig"] = np.stack([np.stack([sd[f"z{k}_coef_{j + 1}"].numpy() for j in range(r)]) for k in KINDS])
    out["c_trig"] = np.array([[float(sd[f"{k}_coef_{j + 1}"]) for j in range(r)] for k in KINDS], np.float32)
    order = ((0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (2, 1))  # omega_phi1..6 as (kind, mode)
    omega = np.zeros((3, r), np.float32)
    for i, (k, j) in enumerate(order):
        omega[k, j] = float(sd[f"omega_phi{i + 1}"])
    out["omega"] = omega
    return out
