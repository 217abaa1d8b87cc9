"""Planner: the batch's preparation, ms a batch: the time under the
port's spans `batch.route` (classification and expansion), `bool.prepare`
and `phrase.prepare` (each fused chain's clause weights, store slabs and
plan-row counts) and `bool.tables` (the boolean chain's plan-row
tables)."""

from searchbench import batch_spans as bs

PREPARE = ("batch.route", "bool.prepare", "phrase.prepare", "bool.tables")


def read(trace):
    return bs.ms_per_batch(trace, lambda b: bs.covered(b, PREPARE))
