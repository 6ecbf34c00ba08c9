"""gofr_tpu_torch — the PyTorch/CUDA port of gofr_tpu's LLM serving path.

Each module keeps the path of its JAX counterpart (``gofr_tpu_torch/X`` ports
``gofr_tpu/X``) and names in its docstring the functions it ports. The
package imports torch and numpy, never jax and never gofr_tpu: what it needs
from gofr_tpu's stdlib-only modules is copied here. Entry points run on the
CUDA device unless the caller passes ``device="cpu"``.
"""
