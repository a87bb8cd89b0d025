"""Readings that the limits of ``correct`` are set from, at a cell's own
size: the program's numbers on many seeds, the control's, and the faults'.

    python3 perfbench/control.py --workload cylinder.one_seed --seeds 1,2,3 --control-seeds 4,5,6

For each of ``--seeds``: the program, as a run's set-up and window drive
it, compared by ``check.compare``: the window's first launch (the
checkpoint cadence's epochs from the initial state, every packed seed's
first epochs against the reference on its own), the state it ends at, as a
run's window checkpoints it at the job's first boundary, and the first
epoch of the next launch from there. For each of ``--control-seeds``:

- ``control``: the reference itself in the program's place, its matrix
  products in TF32 (``reference.<name>.epoch(low=True)``), the precision
  one step below the configuration's float32; its POD by the method of
  snapshots with a TF32 Gram (its epochs take the float32 POD, so that
  its other numbers read the arithmetic alone); its window number the TF32
  loss of the program's checkpointed state of the same seed;
- ``half``: the reference in the program's place trained on the first half
  of the rows, its means over that half (its window number the loss of the
  program's checkpointed state over that half);
- ``later``: the reference in the program's place, sound in a launch of one
  epoch (the set-up's) and on the first half of the rows from the second
  epoch of a longer launch on (the window's);
- ``moments``: the same, with the optimizer's moments dropped after the
  first epoch of a longer launch, in place of the half rows;
- ``unchanged``: a step that returns its state unchanged (and reports the
  loss of that state);
- for a configuration of the Fourier variant (``n_fourier`` > 0), two faults
  of its series: ``periods``, the reference with the periods' step dropped
  (``period`` and ``trig_period`` held at each epoch's start), and
  ``harmonic``, the reference with the top harmonic left out of B (its
  window number the loss so formed of the program's checkpointed state);
- for a configuration with the AE variant's decoder term (``ae_beta`` > 0),
  ``decoder``: the reference with that term left out of the total (its
  window number the loss so formed of the program's checkpointed state).

"The first half of the rows" halves X, the POD modes and the leaves with an
entry per row (the reference's ``ROW_LEAVES``: desmo's masks; none of the
AE variant's, whose MLP every row shares).

Each side's reference is ``reference.<name>`` with the configuration's whole
``run_config`` (the interface ``check.py`` states).

Prints one JSON line per seed and side (with each leaf's ``grad`` and
``update`` gap, and for the program ``free``: at each of the launch's first
five epochs, its gap from the reference run on its own), then the largest
program reading and the smallest reading of each other side, number by
number. Needs the card for the program's side (its kernels); the other
sides run anywhere.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import check, harness, synthetic  # noqa: E402

FREE_EPOCHS = 5  # the epochs of the launch held to the reference run on its own, for the record
SIDES = ("control", "half", "later", "moments", "unchanged")
FOURIER_SIDES = ("periods", "harmonic")
AE_SIDES = ("decoder",)
# the sides whose window number is the program's checkpointed state's loss
# as that side forms it
WINDOW_SIDES = ("control", "half", "harmonic", "decoder")


def sides(rc: dict) -> tuple:
    """The sides other than the program that a cell of ``run_config`` rc
    reads."""
    return SIDES + (FOURIER_SIDES if rc.get("n_fourier", 0) else ()) + (AE_SIDES if rc.get("ae_beta", 0) else ())


def side_config(rc: dict, side: str) -> dict:
    """The ``run_config`` the reference of ``side`` runs with: for
    ``harmonic``, one harmonic fewer in B (the state keeps its shapes); for
    ``decoder``, no decoder term."""
    if side == "harmonic":
        return dict(rc, n_fourier=rc["n_fourier"] - 1)
    return dict(rc, ae_beta=0.0) if side == "decoder" else rc


def rows_of(tree: dict, ref, h: int) -> dict:
    """``tree`` with the reference's ``ROW_LEAVES`` cut to their first h rows."""
    return dict(tree, **{k: tree[k][..., :h] for k in ref.ROW_LEAVES})


def program_numbers(cell, seed: int, device: str) -> dict:
    su = harness.set_up(cell, seed, device)
    obs = harness.observed(su)
    cfg = su.cfg
    S = cfg.n_seeds
    at, m = su.chunk(su.state, su.batch, cfg.checkpoint_every)
    rows = [harness.seed_metrics(m, S, su.ref.METRICS, k) for k in range(FREE_EPOCHS)]
    for s in range(S):
        obs.launch.append((s, [row[s] for row in rows[:harness.FIRST_STEPS]]))
    window_state = None
    if S == 1:
        _, m = su.chunk(at, su.batch, cfg.checkpoint_every)
        window_state = harness.host_states(at, 1, False, su.ref.LEAVES)[0]["params"]
        obs.window.append((window_state, harness.seed_metrics(m, 1, su.ref.METRICS)[0]))
    hypers = [(cfg.beta, cfg.l1_lambda)] * S
    leaves: dict = {}
    numbers = check.compare(obs, cell.config["run_config"], hypers, cell.config["reference"], seed, leaves)
    leaves["free"] = free_gaps(cell, seed, su.x, su.modes, rows)
    return numbers, window_state, leaves


def free_gaps(cell, seed: int, x, modes, rows) -> list:
    """How soon the program and the reference part: at each of the launch's
    first epochs (``rows``, per-seed metrics), the largest relative gap of
    rec, l1 and total over the seeds against the reference run on its own
    from its own initial state."""
    rc = cell.config["run_config"]
    ref = check.reference_module(cell.config["reference"])
    ref.full_fp32()
    want = check.signed_like(ref.pod_modes(x, rc["r"]), modes)
    inits = ref.seed_params(rc, len(rows[0]), seed, x.device)
    gaps = [0.0] * len(rows)
    for s, init in enumerate(inits):
        _, mets = _trajectory(ref, x, want, init, rc, False, rows=(None,) * len(rows))
        for k, (row, m_ref) in enumerate(zip(rows, mets)):
            gaps[k] = max(gaps[k], check._loss_gaps(row[s], m_ref)[0])
    return gaps


def _trajectory(ref, x, modes, init: dict, rc: dict, low: bool, rows=(None,) * 3, drop=False, held=()):
    """Reference epochs of ``run_config`` rc from ``init``, epoch k on the
    first ``rows[k]`` rows of X alone where that is not None, with ``drop``
    the optimizer's moments zeroed after the first, and the parameters
    ``held`` kept as each epoch found them: the states before and after
    each, full width, and the metrics."""
    st = ref.initial_state(init, [rc["lr_coef"], rc["lr_phi"], rc["lr_z"], rc["lr_omega"], rc["lr_period"]])
    states, mets = [st], []
    for h in rows:
        if drop and mets:
            st = dict(st, mu={k: torch.zeros_like(v) for k, v in st["mu"].items()},
                      nu={k: torch.zeros_like(v) for k, v in st["nu"].items()})
        if h is None:
            m, _, nxt = ref.epoch(st, x, modes, rc, rc["beta"], rc["l1_lambda"], low)
        else:
            part = dict(st, **{tree: rows_of(st[tree], ref, h) for tree in ("params", "mu", "nu")})
            m, _, nxt = ref.epoch(part, x[:h], modes[:h], rc, rc["beta"], rc["l1_lambda"], low)
            for tree in ("params", "mu", "nu"):
                for k in ref.ROW_LEAVES:
                    nxt[tree][k] = torch.cat([nxt[tree][k], st[tree][k][..., h:]], dim=-1)
        for k in held:
            nxt["params"][k] = st["params"][k].clone()
        st = nxt
        states.append(st)
        mets.append(m)
    return states, mets


def side_numbers(cell, seed: int, side: str, device: str, window_state=None) -> dict:
    """The numbers of ``side`` (one of :func:`sides`) in the program's
    place."""
    rc = cell.config["run_config"]
    ref = check.reference_module(cell.config["reference"])
    ref.full_fp32()
    S = int(cell.traffic["seeds"])
    dev = torch.device(device)
    x = synthetic.wake(rc["n"], rc["m"], seed, dev)
    modes = ref.pod_modes(x, rc["r"])
    inits = ref.seed_params(rc, S, seed, dev)
    steps = harness.FIRST_STEPS
    h = rc["n"] // 2
    obs = check.Observed(x=x, modes=modes, states=[], metrics=[])
    for s in range(S):
        if side == "control":
            states, mets = _trajectory(ref, x, modes, inits[s], rc, True)
            launch = mets
        elif side == "half":
            states, mets = _trajectory(ref, x, modes, inits[s], rc, False, rows=(h,) * steps)
            launch = mets
        elif side in ("periods", "harmonic", "decoder"):
            states, mets = _trajectory(ref, x, modes, inits[s], side_config(rc, side), False,
                                       held=ref.PERIOD_LEAVES if side == "periods" else ())
            launch = mets
        elif side in ("later", "moments"):
            states, mets = _trajectory(ref, x, modes, inits[s], rc, False)
            if side == "later":
                _, launch = _trajectory(ref, x, modes, inits[s], rc, False, rows=(None,) + (h,) * (steps - 1))
            else:
                _, launch = _trajectory(ref, x, modes, inits[s], rc, False, drop=True)
        else:
            states, mets = _trajectory(ref, x, modes, inits[s], rc, False)
            mets = launch = [mets[0]] * steps
            states = [states[0]] * (steps + 1)
        obs.states.append([{**st, **{t: {k: v.cpu() for k, v in st[t].items()} for t in ("params", "mu", "nu")}}
                           for st in states])
        obs.metrics.append(mets)
        obs.launch.append((s, launch))
    if side in WINDOW_SIDES and window_state is not None:
        params = {k: v.to(dev) for k, v in window_state.items()}
        rows = h if side == "half" else rc["n"]
        with torch.no_grad():
            _, m = ref.loss(rows_of(params, ref, rows), x[:rows], modes[:rows], side_config(rc, side), rc["beta"],
                            rc["l1_lambda"], side == "control")
        obs.window.append((window_state, {k: float(v) for k, v in m.items()}))
    hypers = [(rc["beta"], rc["l1_lambda"])] * S
    leaves: dict = {}
    numbers = check.compare(obs, rc, hypers, cell.config["reference"], seed, leaves)
    numbers["leaves"] = leaves
    if side == "control":
        numbers["pod"] = check.pod_gap(check.signed_like(ref.pod_modes(x, rc["r"], low=True), modes), modes)
    return numbers


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated seeds of the program's readings")
    parser.add_argument("--control-seeds", required=True, help="comma-separated seeds of the other sides")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    cell = harness.find_cell(harness.load_benchmark(ROOT), args.workload, ROOT)
    readings: dict = {}

    def emit(seed, side, numbers, leaves=None):
        leaves = numbers.pop("leaves", leaves)
        print(json.dumps({"workload": cell.name, "seed": seed, "side": side, "numbers": numbers, "leaves": leaves}),
              flush=True)
        readings.setdefault(side, []).append(numbers)

    for seed in (int(s) for s in args.seeds.split(",")):
        numbers, _, leaves = program_numbers(cell, seed, args.device)
        emit(seed, "program", numbers, leaves)
    for seed in (int(s) for s in args.control_seeds.split(",")):
        numbers, window_state, leaves = program_numbers(cell, seed, args.device)
        emit(seed, "program", numbers, leaves)
        for side in sides(cell.config["run_config"]):
            emit(seed, side, side_numbers(cell, seed, side, args.device, window_state))
    summary = {}
    for side, rows in readings.items():
        pick = max if side == "program" else min
        summary[side] = {k: pick(r[k] for r in rows if k in r) for k in rows[0]}
    print(json.dumps({"workload": cell.name, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
