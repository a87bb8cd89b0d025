"""desmo_tpu_torch — the PyTorch/CUDA port of ``desmo_tpu``.

Trains the DESMO model (learnable masks on POD modes, a polynomial +
sin/cos/tanh candidate library, free temporal coefficients, factored MSE +
orthogonality + L1), its Fourier variant (temporal coefficients as
learnable truncated Fourier series) and its autoencoder variant (the latent
modes from an MLP funnel over each point's time series) on one NVIDIA GPU. The JAX package ``desmo_tpu`` stays the
reference: every module here mirrors its counterpart's names and is held
against it by ``tests/test_torch_*.py``.

Modules
-------
- ``configs``     run configurations and the named presets
- ``data``        snapshot-matrix preprocessing
- ``io``          the synthetic generator, VTK readers and the native loader
- ``device``      the one place that resolves the torch device
- ``library``     candidate-term factor tables (term order is a checkpoint contract)
- ``losses``      reconstruction / orthogonality / sparsity objectives
- ``kernels``     hand-written CUDA kernels and their plain PyTorch versions:
  ``train_chunk`` (a whole training chunk per launch), ``ae_chunk`` (the
  same for the AE variant) and ``dual_gemm``
- ``models``      the DESMO model (``models.desmo``), its Fourier variant
  (``models.fourier``) and its AE variant (``models.autoencoder``)
- ``pod``         POD initialization on the host or the device (snapshots, SVD, randomized)
- ``optim``       torch-semantics Adamax + ReduceLROnPlateau on tensor state
- ``train``       the chunked training loop (eager, or the mega-kernel's chunk), its
  graceful preemption and its checkpoint worker
- ``checkpoint``  ``.npz`` run state (written and read back), ``.pt`` export and import, weights and
  state from the JAX package
- ``sparsify``    term energies, threshold sweeps and greedy pruning
- ``logging_utils`` CSV/JSONL metrics
- ``runner``      the end-to-end pipeline behind ``python -m desmo_tpu_torch run``, and ``evaluate``

The package imports nothing of ``desmo_tpu``: ``configs``, ``data``, ``io``
and ``logging_utils`` are its own copies of the reference's jax-free
modules. Importing this package builds no kernel.
"""

__version__ = "0.1.0"
