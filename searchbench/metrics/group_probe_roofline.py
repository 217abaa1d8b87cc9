"""Kernels: the share of its roofline that kernel `group_probe` reaches: the
least time of its logged launches at the card's memory bandwidth over its
device time, in percent; nothing where it did not run."""

from searchbench import tracebook as tb


def read(trace):
    return tb.roofline_pct(trace, ["group_probe"])
