"""falcon-unzip-tpu on PyTorch + CUDA: the 3-unzip slice.

A second package beside the JAX reference ``falcon_unzip_tpu``.  It keeps
the reference's module layout and names; every device op is a torch op
on an explicit ``torch.device``, and the banded edit-distance wavefront
and its traceback are hand-written CUDA kernels (``csrc/``) on a GPU.

Nothing here imports JAX.  From the reference, only its JAX-free host
modules are imported (``seq``, ``config``, ``io.fasta``, ``io.serialize``,
``io.gfa``, ``io.native``, ``oracle.*``, ``graph.string_graph``,
``ops.kmer_index``, ``parallel.checkpoint``, ``parallel.dataflow``,
``parallel.distributed``, ``utils.metrics``, ``utils.simulate``).
"""
__version__ = "0.1.0"
