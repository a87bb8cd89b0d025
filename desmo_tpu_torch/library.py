"""Candidate-term library for DESMO as data: factor tables on numpy, one
gather + product on tensors. Port of ``desmo_tpu/library.py``.

Term order is a checkpoint contract: degree-ascending, and within each degree
``itertools.combinations_with_replacement`` order, so coefficient vectors and
temporal stacks indexed by term line up with the reference's ``.pt`` files.
``tests/test_torch_library_model.py`` holds the tables equal to the JAX
package's bit for bit.
"""

from __future__ import annotations

import itertools
import math
from functools import lru_cache

import numpy as np
import torch

__all__ = [
    "num_poly_terms",
    "monomial_exponents",
    "factor_table",
    "eval_library",
    "poly_term_names",
    "trig_term_names",
    "ref_interleaved_trig_names",
    "TRIG_KINDS",
]

# Order of the nonlinear channels: omega_list[3*i + k] is kind k of mode i.
TRIG_KINDS: tuple[str, str, str] = ("sin", "cos", "tanh")


def num_poly_terms(n_vars: int, poly_order: int) -> int:
    """Number of monomials in ``n_vars`` variables up to total degree ``poly_order``."""
    return sum(math.comb(n_vars + k - 1, k) for k in range(poly_order + 1))


@lru_cache(maxsize=None)
def _term_tuples(n_vars: int, poly_order: int) -> tuple[tuple[int, ...], ...]:
    terms: list[tuple[int, ...]] = []
    for degree in range(poly_order + 1):
        terms.extend(itertools.combinations_with_replacement(range(n_vars), degree))
    return tuple(terms)


def monomial_exponents(n_vars: int, poly_order: int) -> np.ndarray:
    """Exponent matrix ``E (num_terms, n_vars)``: term t = prod_i phi_i**E[t,i]."""
    terms = _term_tuples(n_vars, poly_order)
    E = np.zeros((len(terms), n_vars), dtype=np.int32)
    for t, tup in enumerate(terms):
        for v in tup:
            E[t, v] += 1
    return E


def factor_table(n_vars: int, poly_order: int) -> np.ndarray:
    """Factor-index table ``F (num_terms, poly_order)`` into ``[1, phi_1..phi_r]``.

    Index 0 is the constant-one column, index i+1 is mode i; degree-d terms
    are padded with zeros so every term is a product of ``poly_order``
    gathered columns (a gather keeps the gradient finite where a mode is 0)."""
    if poly_order < 1:
        raise ValueError("poly_order must be >= 1")
    terms = _term_tuples(n_vars, poly_order)
    F = np.zeros((len(terms), poly_order), dtype=np.int32)
    for t, tup in enumerate(terms):
        for p, v in enumerate(tup):
            F[t, p] = v + 1
    return F


def eval_library(latent: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Polynomial library ``latent (n, r)`` -> ``theta (n, T)``: gather the
    ``(n, T, P)`` factors from ``[1 | latent]`` and take the product over P.

    ``factors`` is the int64 factor table on ``latent``'s device. The
    product is written out over P: the backward of ``Tensor.prod`` checks
    its input for zeros with a blocking ``.item()``, a host sync per step."""
    aug = torch.cat([torch.ones_like(latent[:, :1]), latent], dim=1)  # (n, r+1)
    gathered = aug[:, factors]  # (n, T, P)
    theta = gathered[..., 0]
    for p in range(1, gathered.shape[-1]):
        theta = theta * gathered[..., p]
    return theta


def poly_term_names(n_vars: int, poly_order: int, var: str = "phi") -> list[str]:
    """Human-readable name of each polynomial term: '1', 'phi1', 'phi1^2', 'phi1*phi2', ..."""
    names = []
    for tup in _term_tuples(n_vars, poly_order):
        if not tup:
            names.append("1")
            continue
        parts = []
        for v, grp in itertools.groupby(tup):
            count = len(list(grp))
            base = f"{var}{v + 1}"
            parts.append(base if count == 1 else f"{base}^{count}")
        names.append("*".join(parts))
    return names


def ref_interleaved_trig_names(n_vars: int, var: str = "phi") -> list[str]:
    """Nonlinear-term names in the reference's interleaved (mode-major)
    order: sin(phi1), cos(phi1), tanh(phi1), sin(phi2), ... (the order of
    the reference's ``nonlinear_norm``)."""
    return [f"{kind}({var}{i + 1})" for i in range(n_vars) for kind in TRIG_KINDS]


def trig_term_names(n_vars: int, var: str = "phi") -> list[str]:
    """Names of the 3r nonlinear terms, in (kind-major, mode) storage order."""
    return [f"{kind}({var}{i + 1})" for kind in TRIG_KINDS for i in range(n_vars)]
