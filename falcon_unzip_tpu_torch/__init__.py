"""falcon-unzip-tpu on PyTorch + CUDA: 3-unzip and 4-polish.

A second package beside the JAX reference ``falcon_unzip_tpu``.  It keeps
the reference's module layout and names; every device op is a torch op
on an explicit ``torch.device``, and on a GPU the banded edit-distance
wavefront and its traceback, the banded pair-HMM forward and the Arrow
splice row sweeps are hand-written CUDA kernels (``csrc/``).

Nothing here imports JAX or the reference package.  The reference's
host modules the port runs are copied into it at the same paths, bodies
unchanged (``seq``, ``config``, ``io.*``, ``oracle.*``,
``graph.string_graph``, ``ops.kmer_index``, ``parallel.checkpoint``,
``parallel.dataflow``, ``pack_arrays``/``unpack_arrays`` of
``parallel.distributed``, ``utils.metrics``, ``utils.simulate`` and the
native IO library under ``native/``); ``tests/test_torch_copies.py``
holds each copy to its original.
"""
__version__ = "0.1.0"
