"""falcon-unzip-tpu on PyTorch + CUDA: 3-unzip and 4-polish.

A second package beside the JAX reference ``falcon_unzip_tpu``.  It keeps
the reference's module layout and names; every device op is a torch op
on an explicit ``torch.device``, and on a GPU the banded edit-distance
wavefront and its traceback, the banded pair-HMM forward and the Arrow
splice row sweeps are hand-written CUDA kernels (``csrc/``).

Nothing here imports JAX.  From the reference, only its JAX-free host
modules are imported (``seq``, ``config``, ``io.fasta``, ``io.serialize``,
``io.gfa``, ``io.native``, ``oracle.*``, ``graph.string_graph``,
``ops.kmer_index``, ``parallel.checkpoint``, ``parallel.dataflow``,
``parallel.distributed``, ``utils.metrics``, ``utils.simulate``).
"""
__version__ = "0.1.0"
