"""MB the program's host code writes into host memory per call: the sum
of every ``host_bytes.*`` counter over ``calls.api.compress``, over all the
process's calls, warm-up ones included (``attribution``)."""

from portbench import attribution


def read(run, spec):
    return attribution.per_call_mb("host_bytes", "calls.api.compress")
