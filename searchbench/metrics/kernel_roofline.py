"""Kernels: the least time of the port's kernel launches at the card's
memory bandwidth (the bytes each logged launch must move, `roofline.py`)
over their device time, in percent, over the kernels with byte counts."""

from searchbench import tracebook as tb


def read(trace):
    return tb.roofline_pct(trace)
