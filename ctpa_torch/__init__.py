"""ctpa_torch — the PyTorch/CUDA port of ``ctpa`` for one NVIDIA H100.

The package mirrors ``ctpa``'s layout (``core/``, ``ops/``, ``models/``,
``eval/``, ``data/``) so each counterpart is found by path.  It imports
``torch``, numpy and einops, and never JAX or any module of ``ctpa``.
Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``.  The two hand-written kernels of the serving path live in
``csrc/`` and are built at first use by ``kernels/build.py``.
"""
