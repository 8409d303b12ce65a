"""Synthetic diploid genomes and long reads, for tests and smoke runs.

The reference's simulator (``falcon_unzip_tpu.utils.simulate``) is
JAX-free host numpy; the port uses it as is, so a seed gives the same
genome and reads in both packages.
"""
from falcon_unzip_tpu.utils.simulate import (Diploid, SimReads, make_diploid,
                                             mutate_read, random_genome,
                                             simulate_reads)

__all__ = ["Diploid", "SimReads", "make_diploid", "mutate_read",
           "random_genome", "simulate_reads"]
