"""PyTorch/CUDA port of the Dalorex engine and of granite-3-2b serving
(the JAX package ``repro`` is the reference it is held against, module
for module).

The layout copies ``src/repro/``: the port of ``repro.core.engine`` is
``repro_torch.core.engine``.  The package imports ``torch`` and numpy
only.  Entry points put their tensors on ``device="cuda"`` unless the
caller asks for the CPU; on the card the engine's per-tile building
blocks launch the hand-written Hopper kernels of
:mod:`repro_torch.kernels.engine`, on the CPU they run the kernels'
plain PyTorch versions.  The LM's serving path
(:mod:`repro_torch.models.transformer`) launches the flash-attention
kernel of :mod:`repro_torch.kernels.flash_attention` in its prefill.
"""
