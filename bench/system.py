"""The system under test, built from the benchmark's own inputs.

The only module of the benchmark that imports the program
(``repro_torch``): it hands the generated CSR arrays to the program's
``Graph``, partitions and binds an ``Engine`` as the configuration says,
and puts a ``GraphQueryServer`` in front of it for the serving cells.
The configuration's ``partition``, ``engine`` and ``server`` objects are
passed through as keyword arguments, so a key the program does not take
fails the run instead of being ignored.
"""

from __future__ import annotations

import time

from bench.graphgen import Csr


def build_engine(csr: Csr, cfg: dict, device):
    """``Engine(partition(Graph(...), **cfg["partition"]),
    **cfg["engine"])``: the layout the strategy reads is built here, in
    set-up."""
    from repro_torch.core.engine import Engine
    from repro_torch.core.graph import Graph, partition

    g = Graph(num_vertices=csr.num_vertices, indptr=csr.indptr, dst=csr.dst,
              weight=csr.weight)
    pg = partition(g, eager=False, **cfg["partition"])
    return Engine(pg, device=device, **cfg["engine"])


def build_server(engine, server_cfg: dict):
    """``GraphQueryServer(engine, **server_cfg)`` on the host's monotonic
    performance clock, its ``policy`` the named class of the program's
    serving module."""
    from repro_torch.launch import serve

    kw = dict(server_cfg)
    policy = getattr(serve, kw.pop("policy"))()
    return serve.GraphQueryServer(engine, policy=policy,
                                  clock=time.perf_counter, **kw)
