"""MB of pageable host arrays the program allocates anew per call: the
sum of every ``fresh_bytes.*`` counter over ``calls.api.compress``, over all
the process's calls, warm-up ones included (``attribution``)."""

from portbench import attribution


def read(run, spec):
    return attribution.per_call_mb("fresh_bytes", "calls.api.compress")
