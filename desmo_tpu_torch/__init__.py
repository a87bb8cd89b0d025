"""desmo_tpu_torch — the PyTorch/CUDA port of ``desmo_tpu``.

Trains the DESMO model (learnable masks on POD modes, a polynomial +
sin/cos/tanh candidate library, free temporal coefficients, factored MSE +
orthogonality + L1) on one NVIDIA GPU. The JAX package ``desmo_tpu`` stays the
reference: every module here mirrors its counterpart's names and is held
against it by ``tests/test_torch_*.py``.

Modules
-------
- ``device``      the one place that resolves the torch device
- ``library``     candidate-term factor tables (term order is a checkpoint contract)
- ``losses``      reconstruction / orthogonality / sparsity objectives
- ``kernels``     hand-written CUDA kernels and their plain PyTorch twins
- ``models``      the DESMO model (``models.desmo``)
- ``pod``         host POD initialization
- ``optim``       torch-semantics Adamax + ReduceLROnPlateau on tensor state
- ``train``       the chunked eager training loop
- ``checkpoint``  ``.npz`` run state, ``.pt`` export, weights from the JAX package
- ``sparsify``    term energies and threshold sweeps
- ``runner``      the end-to-end pipeline behind ``python -m desmo_tpu_torch run``

Only ``desmo_tpu``'s jax-free modules (``configs``, ``data``, ``io``,
``logging_utils``) are imported from the reference package. Importing this
package builds no kernel.
"""

__version__ = "0.1.0"
