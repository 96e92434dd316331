"""Actor-model graph processing with COST accounting, in PyTorch.

The port of ``repro.core`` (the JAX reference, which stays as it is).
Public API, for what is ported:
    Graph / partition / generators          repro_torch.core.graph
    Partitioner registry / PartitionPlan    repro_torch.core.partitioners
    Engine (strategy x vertex program)      repro_torch.core.engine
    VertexProgram / registry / run_parallel repro_torch.core.programs
    pagerank_serial / pagerank_parallel     repro_torch.core.pagerank
    labelprop_serial / labelprop_parallel   repro_torch.core.labelprop
    sssp_serial / bfs_serial / weighted PR  repro_torch.core.programs
    run_cost / wire_model                   repro_torch.core.cost
"""

from repro_torch.core.graph import (Graph, PartitionedGraph, from_edges,
                                    graph_from_reference, partition, rmat,
                                    erdos_renyi, ring, two_cliques,
                                    random_weights, load_dataset,
                                    dataset_names)
from repro_torch.core.partitioners import (PartitionPlan, PartitionerSpec,
                                           get_partitioner, make_plan,
                                           partition_stats,
                                           partitioner_names, policy_label,
                                           register_partitioner)
from repro_torch.core.engine import Engine
from repro_torch.core.programs import (VertexProgram, ProgramSpec,
                                       make_program, get_spec,
                                       registered_names, run_parallel,
                                       sssp_serial, bfs_serial,
                                       pagerank_weighted_serial)
from repro_torch.core.pagerank import pagerank_serial, pagerank_parallel
from repro_torch.core.labelprop import (labelprop_serial, labelprop_parallel,
                                        components_oracle)
from repro_torch.core.cost import run_cost, wire_model, CostReport
