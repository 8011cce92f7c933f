"""The JAX package's PyTorch examples on the port, each run as
``python -m horovod_tpu_torch.examples.<name>`` (on the card by default;
``--device cpu`` for the CPU): ``synthetic_benchmark``, ``mnist`` and
``bert_large_sparse``."""
