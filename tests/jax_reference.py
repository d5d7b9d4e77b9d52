"""Shared set-up of the port's tests that run JAX as the reference.

``no_persistent_compile_cache`` (autouse wherever a test module imports
it): the JAX trainers and ``predict.main`` turn on the persistent XLA
compilation cache (``mvuld_tpu/parallel/mesh.py`` ``enable_compile_cache``,
shared ``~/.cache/mvuld_jax_cache``) for every later test their worker
process runs, and an XLA:CPU executable loaded from that cache may have
been compiled on another machine. A port test that holds the port against
JAX at 1e-5 must compare with a program compiled here, so the fixture
turns the cache off around each test and resets JAX's cache state on both
sides; JAX mains called from port tests get ``MVULD_CACHE_DIR=""`` as
well, so they never turn it on.

``one_torch_thread``: the port's CPU runs of many small ops (the
baselines' trainers, GRU and TreeLSTM loops) slow down many times over
when torch's intra-op threads compete with the other test workers' for
the cores; a module that names the fixture runs torch on one thread, and
the thread count is restored after each test.
"""

import jax
import pytest
from jax.experimental.compilation_cache import compilation_cache


@pytest.fixture(autouse=True)
def no_persistent_compile_cache(monkeypatch):
    monkeypatch.setenv("MVULD_CACHE_DIR", "")
    before = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", before)
    compilation_cache.reset_cache()


@pytest.fixture
def one_torch_thread():
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
