"""MB the unpack kernels write on the device per call, in the lanes they
decode into: the sum of every ``unpack_out_bytes.*`` counter over
``calls.api.decompress``, over all the process's calls, warm-up ones
included (``attribution``); None where the program keeps no such
counter."""

from portbench import attribution


def read(run, spec):
    c = attribution.program_counters() or {}
    if not any(k.startswith("unpack_out_bytes.") for k in c):
        return None
    return attribution.per_call_mb("unpack_out_bytes", "calls.api.decompress")
