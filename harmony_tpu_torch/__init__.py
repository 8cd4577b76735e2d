"""harmony_tpu_torch — the harmony_tpu training framework in PyTorch and CUDA.

A port of ``harmony_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100. Module
names mirror the reference package (``harmony_tpu_torch/table/table.py`` is the
counterpart of ``harmony_tpu/table/table.py``); every Pallas kernel on a ported
path is a hand-written CUDA kernel for ``sm_90a`` in ``csrc/``, with its plain
PyTorch version beside it in ``ops/``. The package imports ``torch`` and numpy,
never ``jax`` and nothing of ``harmony_tpu``.

Entry point: ``python -m harmony_tpu_torch.cli run widedeep`` (or ``run lm``)
trains on the card (``--device cpu`` only when asked).
"""
