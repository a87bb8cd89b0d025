"""Named experiment presets reproducing the five shipped reference runs.

The reference has no config system — every knob is a module-level constant
edited per script (SURVEY §5.6). Each preset below captures one shipped
(variant x dataset) combination exactly, with `file:line` provenance in the
field comments. ``get(name)`` is the single entry point used by the trainer,
CLI and benchmarks.

The port's own copy of ``desmo_tpu/configs.py``: the same ``RunConfig``,
``GROUP_ORDER`` and presets, held equal field for field by
``tests/test_torch_io.py``. A port feature that reads a field the port does
not run yet refuses it in ``runner.check_supported``.
"""

from __future__ import annotations

import dataclasses

GROUP_ORDER = ("coef", "phi", "z", "omega", "period")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    name: str
    variant: str  # "desmo" | "fourier" | "ae"
    # --- data shape (from the shipped logs, SURVEY §2.1) ---
    n: int
    m: int
    # --- model (SURVEY §2.5) ---
    r: int
    poly_order: int
    omega_init: float = 10000.0
    n_fourier: int = 0  # Fourier variant only
    period_init: float = 0.0  # Fourier variant only
    # Fourier period multi-start (beyond reference — the learnable periods
    # have a no-gradient basin when period_init is far from the data's true
    # period; see models/fourier.period_candidates): probe up to this many
    # FFT-informed candidate periods for period_probe_epochs each, keep the
    # best state by rec loss. 0/1 = off (reference behavior).
    period_multistart: int = 0
    period_probe_epochs: int = 300
    # --- loss (SURVEY §2.6) ---
    beta: float = 1e-3  # orthogonality weight
    l1_lambda: float = 1e-4  # sparsity weight
    ae_beta: float = 0.0  # AE variant auxiliary reconstruction weight
    # AE convergence recipe: rescale the omega init from the initial latent
    # RMS (keeps the reference 1:0.1:0.01 channel ratio but makes the args
    # O(1) in any data units — see models/autoencoder.data_scaled_omega)
    ae_omega_data_scaled: bool = False
    # Full AE convergence recipe (--ae-recipe): live MLP init (He weights +
    # 0.01 hidden biases; the reference's Xavier/zero-bias init produces an
    # exactly-dead decoder funnel — autoencoder.init_params_live), MLP lr
    # capped at 1e-3, an AE-only warmup phase of ae_warmup_epochs, then joint
    # training with data-scaled omega and proportionally scaled lr_omega.
    ae_recipe: bool = False
    # 2000 = the round-5 full-length hyper-sweep winner (with the recipe's
    # ae_beta floor of 10): err 0.1216 at the POD(4)=0.1228 bracket on the
    # synthetic cylinder — scripts/ae_hyper_sweep.py, docs/RESULTS.md
    ae_warmup_epochs: int = 2000
    # --- optimizer groups, order = GROUP_ORDER (CYL:592-612) ---
    lr_coef: float = 1e-2
    lr_phi: float = 1e-3
    lr_z: float = 1e-2
    lr_omega: float = 1e3
    lr_period: float = 1e-2
    # --- schedule (CYL:614, 776-778) ---
    num_epochs: int = 100_000
    patience: int = 1000
    sched_factor: float = 0.1
    sched_min_lr: float = 1e-6
    sched_every: int = 1  # cylinder variants step the scheduler every 10 epochs
    # --- bookkeeping ---
    seed: int = 42
    log_every: int = 10
    checkpoint_every: int = 2000
    # --- loss evaluation path: 'auto' = Pallas-fused on TPU, factored Gram
    # products elsewhere; 'direct' materializes the (n, m) reconstruction ---
    loss_method: str = "auto"
    # POD initialization path: 'host' = np.linalg.svd with the reference's
    # exact mode signs (CYL:199-205; required when pairing with imported
    # reference checkpoints); 'snapshots' / 'svd' / 'randomized' run on
    # device (pod.pod) under pod.canonical_signs so train -> evaluate round
    # trips rebuild identical signs. 'randomized' (Halko range finder,
    # O(n*m*k)) is for meshes where even the m x m Gram is too expensive.
    pod_method: str = "host"
    # scan-unroll factor of the compiled training loop: amortizes the TPU
    # runtime's per-iteration while-loop overhead (~20 us on v5e); purely a
    # compile-time schedule choice, numerics are unchanged
    scan_unroll: int = 4
    # compiled-chunk implementation: 'auto' = resident mega-kernel where
    # supported (desmo variant on TPU; ~1.5x faster, contraction precision
    # ~4e-6 relative vs the scanned chunk's mixed 4e-6/1e-7), 'scan' forces
    # the scanned chunk, 'megakernel' requires the mega-kernel
    chunk_method: str = "auto"
    # mega-kernel only: compute the Gram of the dictionary (ga) in ONE bf16
    # MXU pass instead of the hi/lo 3-pass form (~2e-3 relative on ga; the
    # 3-pass ~5e-6 contract exists for the X-cancellation terms of ax, which
    # KEEPS all three passes). Measured round 5 (docs/RESULTS.md): -3.7
    # us/step on cylinder (68.8 -> 65.1, A/B same-window) with full-length
    # convergence unchanged (err 0.0126 vs 0.0158 baseline, both in POD
    # bounds); +17-19% steps/s on the MXU-bound presets with errors in POD
    # bounds at 30k epochs. Default off: the kernel<->scan parity suites pin
    # the 3-pass numerics; every mega-kernel preset opts in.
    ga_single_pass: bool = False
    # --- preprocessing (SURVEY §2.2) ---
    scale_inv_sqrt_m: bool = False  # aneurysm runs scale X by 1/sqrt(m)
    time_stride: int = 1  # channel subsamples every 2nd snapshot
    dim: int = 2  # 2: strip w + planar magnitude; 3: 3-component magnitude
    # --- post-analysis: greedy one-at-a-time pruning (channel only) ---
    run_greedy_prune: bool = False
    # --- lane-packed multi-seed training (beyond reference; ensemble.py):
    # train n_seeds independently-initialized models simultaneously, packing
    # their K-term lane axes into the MXU's 128-lane pad (up to
    # ensemble.max_seeds_packed per compiled group), keep the best by final
    # total loss. 0/1 = off. Seed 0 keeps the exact reference init; later
    # seeds jitter phi by (1 + sigma*N(0,1)) and omega log-uniformly within
    # 10**[-spread, +spread]. desmo variant only.
    n_seeds: int = 1
    seed_phi_sigma: float = 0.02
    seed_omega_spread: float = 0.0
    # --- hyperparameter multi-start (beyond reference; ensemble.resolve_
    # hypers): value lists whose cartesian product forms a (beta, l1_lambda,
    # lr_scale) combo grid; packed seed s trains under combo s mod #combos —
    # S hyperparameter settings for ~the cost of one run (beta/lambda ride
    # per-seed kernel lanes, lr_scale scales each seed's LR row). Empty = off
    # (that axis keeps the cfg value). Requires n_seeds > 1; the winning seed
    # is then picked by REC error (totals weight ortho/L1 differently).
    sweep_beta: tuple = ()
    sweep_lam: tuple = ()
    sweep_lr_scale: tuple = ()

    @property
    def group_lrs(self) -> tuple[float, ...]:
        return (self.lr_coef, self.lr_phi, self.lr_z, self.lr_omega, self.lr_period)


_PRESETS: dict[str, RunConfig] = {}


def _register(cfg: RunConfig) -> RunConfig:
    _PRESETS[cfg.name] = cfg
    return cfg


# DESMO/cylinder_flow/DESMO-Cylinder.py — n,m from DESMO.out:2; hypers at
# CYL:333-334,583-584,699-701,614,776-778.
CYLINDER = _register(
    RunConfig(
        name="cylinder",
        variant="desmo",
        n=3961,
        m=1001,
        r=4,
        poly_order=3,
        beta=1e-3,
        l1_lambda=1e-4,
        num_epochs=100_000,
        patience=1000,
        sched_every=10,
        # single-pass ga Gram: -3.7 us on this launch/VPU-bound step with
        # full-length convergence verified equal-quality (round 5)
        ga_single_pass=True,
    )
)

# DESMO/aneurysm/DESMO_ICA_norm.py:272-273,520,551,562-564,613 (+1/sqrt(m)
# scaling at :143); 27000 = 30^3 voxels (DESMO/aneurysm/DESMO.out:2).
ANEURYSM = _register(
    RunConfig(
        name="aneurysm",
        variant="desmo",
        n=27_000,
        m=1000,
        r=4,
        poly_order=2,
        beta=1e-3,
        l1_lambda=1e-4,
        num_epochs=100_000,
        patience=200,
        sched_every=1,
        scale_inv_sqrt_m=True,
        dim=3,  # aneurysm keeps 3 components for the magnitude (DESMO_ICA_norm.py:104-127)
        # round-5 measured: +17% steps/s, err 0.059 vs 0.047 at 30k epochs,
        # both deep in POD bounds (docs/RESULTS.md "single-pass ga")
        ga_single_pass=True,
    )
)

# DESMO/turbulent_channel/DESMO-TurbulentChannel.py:331-332,581,612,623-625,672;
# 16384 = 128^2 slice; stride-2 subsample at :189.
CHANNEL = _register(
    RunConfig(
        name="channel",
        variant="desmo",
        n=16_384,
        m=1000,
        r=4,
        poly_order=2,
        beta=1e-6,
        l1_lambda=1e-4,
        num_epochs=60_000,
        patience=2000,
        sched_every=1,
        time_stride=2,
        dim=3,  # channel converts 3-component data to magnitude (...py:170-178)
        run_greedy_prune=True,
        # round-5 measured: +19% steps/s, err in POD bounds (docs/RESULTS.md)
        ga_single_pass=True,
    )
)

# DESMO_Fourier/cylinder_flow/DESMO-Cylinder.py:314-315,596-600,634,727-729,775-777.
FOURIER_CYLINDER = _register(
    RunConfig(
        name="fourier_cylinder",
        variant="fourier",
        n=3961,
        m=1001,
        r=2,
        poly_order=2,
        n_fourier=10,
        period_init=60.0,
        beta=1e-3,
        l1_lambda=1e-4,
        num_epochs=90_000,
        patience=1000,
        sched_every=10,
        # round-5 measured: err bit-close (0.1043 vs 0.1063), large
        # throughput win (docs/RESULTS.md "single-pass ga")
        ga_single_pass=True,
    )
)

# DESMO_Fourier/aneurysm/DESMOFourier_v2.py:267-268,622-624,655,753-755,803.
FOURIER_ANEURYSM = _register(
    RunConfig(
        name="fourier_aneurysm",
        variant="fourier",
        n=27_000,
        m=1000,
        r=2,
        poly_order=2,
        n_fourier=30,
        period_init=1000.0,
        beta=1e-3,
        l1_lambda=1e-4,
        num_epochs=100_000,
        patience=500,
        sched_every=1,
        scale_inv_sqrt_m=True,
        dim=3,
        # round-5 measured: +18% steps/s, err 0.12808 vs 0.12816 (docs/RESULTS.md)
        ga_single_pass=True,
    )
)

# DESMO_AE/DESMO_Cylinder_AE-Final.py:775-777,784-811,849-852,915; seed 43
# (:822-842). Omega LR is 1e2 and everything else 1e-2 in the AE run.
AE_CYLINDER = _register(
    RunConfig(
        name="ae_cylinder",
        variant="ae",
        n=3961,
        m=1001,
        r=2,
        poly_order=2,
        beta=1e-3,
        l1_lambda=1e-6,
        ae_beta=1e-3,
        lr_coef=1e-2,
        lr_phi=1e-2,  # AE weights use the default group lr=1e-2
        lr_z=1e-2,
        lr_omega=1e2,
        num_epochs=100_000,
        patience=5000,
        sched_every=1,
        seed=43,
    )
)


def get(name: str) -> RunConfig:
    try:
        return _PRESETS[name]
    except KeyError:
        raise KeyError(f"unknown preset {name!r}; available: {sorted(_PRESETS)}") from None


def names() -> list[str]:
    return sorted(_PRESETS)
