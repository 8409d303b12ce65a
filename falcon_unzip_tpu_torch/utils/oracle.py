"""The reference's numpy oracles, for checks of the port.

``falcon_unzip_tpu.oracle`` is JAX-free host numpy that defines the exact
semantics every device path is held to; the port re-exports the pieces
its checks use, so a script on a machine without JAX reaches them
through the port alone.
"""
from falcon_unzip_tpu.oracle.hmm import polish_window_oracle

__all__ = ["polish_window_oracle"]
