"""audio_training_tpu_torch — the PyTorch/CUDA port of audio_training_tpu.

The JAX package ``audio_training_tpu`` is the reference; this package grows
beside it with the same subpackage layout.  It imports ``torch`` and
``numpy`` only — never ``jax``, ``flax`` or any module of the JAX package —
and keeps its own copies of the host-side code it needs.  Where the JAX
package has a Pallas kernel, this package has a hand-written CUDA kernel
for Hopper (``csrc/``), bound with ``ctypes`` and paired with a plain
PyTorch version that runs on CPU tensors.

Entry points take an explicit ``device`` argument (default ``"cuda"``).
"""

__version__ = "0.1.0"
