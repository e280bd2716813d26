"""Worked examples on the port, the counterparts of the JAX package's
``examples/``:

    python -m qldpc_tpu_torch.examples.toy_example [--device cpu]
    python -m qldpc_tpu_torch.examples.toy_422 [--device cpu]

Each runs on ``cuda`` by default and raises without a GPU; ``--device cpu``
runs the plain versions.
"""
