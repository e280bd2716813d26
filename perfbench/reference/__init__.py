"""Plain reference of one pooled decode round, in PyTorch and NumPy.

From the benchmark's own draws and matrices it works out what every layer of
the round computes, for each decoding basis:

* ``sampling``: per-location fault bits -> syndromes and true logicals;
* ``bp``: flooding normalized min-sum with a per-iteration alpha and a
  clip, each shot stopped at its first syndrome-satisfying iteration, and
  the iterations each shot needs; ``bp_layered``: the time-layered
  schedule (even cycles' checks, then odd ones, a sweep), counted in
  sweeps; the configuration's ``decoder.bp`` chooses
  (``decode.SCHEDULES``);
* ``osd``: ordered-statistics decoding as the JAX package defines it:
  columns in ascending |posterior LLR| (stable), the first K of them plus a
  fixed greedy column basis of H, a greedy swap-free Gauss-Jordan pivoting
  stopped once the residual syndrome lies in the pivot span, order-w
  reprocessing of the shots whose OSD-0 fails;
* ``decode``: the readout (BP's logical action, corrected by OSD's on the
  shots BP left unconverged) and the per-shot flags.

It imports nothing of the program and takes nothing the program made: it
derives its own neighbour layout, column basis and reliability order from
the arrays it is handed. Its float32 arithmetic is the configuration's
decoder's, operation for operation, and each column's posterior sums its
check messages in the order the program's lifted layout does, an order the
reference works out from H and the code's group alone (``bp.sum_keys``):
min-sum is chaotic on the shots it leaves unconverged, so a reference that
rounded its sums in another order would disagree with a sound program on a
few per cent of shots. The elimination works on 64-bit words over rows,
which changes no answer.
"""
