"""PyTorch + CUDA port of the federated DCCO system (``repro``).

The package mirrors the layout of the JAX package module for module and
keeps its public layouts (images NHWC, encodings ``(N, d)``, linear
weights ``(d_in, d_out)``). Parameters are nested dicts and lists of
tensors, and models are plain functions over them, so ``torch.func``
transforms play the role of ``jax.vmap``/``jax.grad``.

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``
(see :func:`repro_torch.utils.resolve_device`). The phase-1 statistics
go through a hand-written CUDA kernel (:mod:`repro_torch.kernels`).
"""
