"""Percent of the traced window in which a call runs, the card is idle
and no ``trpx.*`` span of the program is open (``attribution``)."""

from portbench import attribution


def read(run, spec):
    return attribution.unattributed_pct(run.trace)
