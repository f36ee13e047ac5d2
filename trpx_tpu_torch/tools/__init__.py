"""Measuring and checking tools of the port, each run as a module:

* ``differential_campaign`` — randomized differential soak of the codec
  engines and its fixed ``--smoke`` tier on the card;
* ``scaling`` — sharded encode frames/s over 1, 2, 4, ... cards and the
  scaling efficiency;
* ``walk_bench`` — the native host header walk on the flagship workloads.
"""
