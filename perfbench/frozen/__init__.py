"""The benchmark's frozen copy of the circuit-to-matrix arithmetic.

``bb.py``, ``circuit.py``, ``builder.py``, ``pauli_frame.py`` and ``gf2.py``
are copies of the same files of ``qldpc_tpu_torch/models/``, kept here so
that a change to the program cannot change the matrices the benchmark
decodes and judges against. Departures from the originals: the native
(g++) paths of the frame propagation and of the GF(2) ranks and column bases
are removed (NumPy only; nothing here builds or imports the program), and
what the matrices do not need is left out (the code registry, the raw-CSS
code class, the npz persistence and the GF(2) solvers), since each
configuration file states its code's polynomials.
"""
