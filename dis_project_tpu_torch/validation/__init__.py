"""Cross-framework validation stack (torch CPU parity oracle): the port's
own copy of ``dis_project_tpu/validation``.

Plays the role of the reference's GPyTorch/ALFI second implementation
(``src/gpytorch_alfi/``): the same SIMM math written independently in torch
with an eager trainer and blockwise Gram assembly, used to validate the JAX
framework's values, gradients, and trained posteriors (tests/test_validation.py).

License lineage: the reference's torch stack is a refactor of the ALFI
package (MIT, Jacob Moss; reference ``src/gpytorch_alfi/__init__.py:1-8``).
This stack re-implements the same behavioral contract from scratch (plain
``torch.nn.Module`` + ``torch.linalg``, no gpytorch classes); the lineage is
acknowledged in the repository LICENSE file.
"""

from dis_project_tpu_torch.validation.torch_lfm import TorchSIMM

__all__ = ["TorchSIMM"]
