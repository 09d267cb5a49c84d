"""SWARM on PyTorch: the streaming main path with a CUDA data plane, and
the LM serving path (``models``, ``serve``, ``launch.serve``) whose
attention and expert histogram run on hand-written CUDA kernels.

The layout and module names follow the JAX package ``repro`` module for
module (``repro_torch.core.protocol``, ``repro_torch.streaming.planes``,
``repro_torch.kernels.stats_update``), so each module's counterpart is
found by its path.  Host modules are NumPy copies; the device side is
:class:`~repro_torch.streaming.planes.TorchPlane` and the hand-written
CUDA kernels under ``repro_torch.kernels``.
"""
