"""The paper's own experiment configuration: graphs x algorithms x variants.

A copy of ``repro/configs/graphs.py`` (the port imports nothing of the
reference).  Real datasets (soc-LiveJournal1 / twitter_rv / uk-2007-05) are
not available offline; ``core.graph.load_dataset`` provides scaled RMAT
stand-ins with the paper's edge/vertex ratios.  PE counts follow the
paper's sweep (1..128).
"""

GRAPHS = {
    # name: (dataset key, paper V, paper E, serial PageRank s, serial LP s)
    "soc-LiveJournal1": ("soc-lj1-mini", 4_847_571, 68_993_773, 3.18, 1.05),
    "twitter_rv": ("twitter-mini", 61_578_415, 1_468_365_182, 180.69, 71.85),
    "uk-2007-05": ("uk-2007-mini", 105_896_555, 3_738_733_648, 83.62, 83.59),
}

# the algorithm suite is the vertex-program registry
# (repro_torch.core.programs.registered_names()), not a constant here
VARIANTS = ("reduction", "sortdest", "basic", "pairs")
PE_SWEEP = (1, 2, 4, 8, 16, 32, 64, 128)
PAGERANK_ITERS = 20
ALPHA = 0.85
