"""Actor-model graph processing with COST accounting, in PyTorch.

The port of ``repro.core`` (the JAX reference, which stays as it is).
Public API, for what is ported:
    Graph / partition / generators          repro_torch.core.graph
    Partitioner registry / PartitionPlan /
    GridPlan (the grid(R,C) family) /
    row_plan_of                             repro_torch.core.partitioners
    Engine (strategy x vertex program) /
    ReplanPolicy / StreamConfig             repro_torch.core.engine
    ShardSource (out-of-core edge windows)  repro_torch.core.graph
    VertexProgram / registry / run_parallel repro_torch.core.programs
    pagerank_serial / pagerank_parallel     repro_torch.core.pagerank
    labelprop_serial / labelprop_parallel   repro_torch.core.labelprop
    sssp_serial / bfs_serial / weighted PR  repro_torch.core.programs
    personalized_pagerank_serial            repro_torch.core.programs
    run_cost / wire_model /
    grid_collective_bytes                   repro_torch.core.cost
"""

from repro_torch.core.graph import (Graph, PartitionedGraph, from_edges,
                                    graph_from_reference, partition, rmat,
                                    erdos_renyi, ring, two_cliques,
                                    random_weights, load_dataset,
                                    dataset_names, ShardSource)
from repro_torch.core.partitioners import (GridPlan, PartitionPlan,
                                           PartitionerSpec, get_partitioner,
                                           grid_shape, make_plan,
                                           partition_stats,
                                           partitioner_names, policy_label,
                                           register_partitioner, row_plan_of)
from repro_torch.core.engine import Engine, ReplanPolicy, StreamConfig
from repro_torch.core.programs import (VertexProgram, ProgramSpec,
                                       make_program, get_spec,
                                       registered_names, run_parallel,
                                       sssp_serial, bfs_serial,
                                       pagerank_weighted_serial,
                                       personalized_pagerank_serial)
from repro_torch.core.pagerank import pagerank_serial, pagerank_parallel
from repro_torch.core.labelprop import (labelprop_serial, labelprop_parallel,
                                        components_oracle)
from repro_torch.core.cost import (run_cost, wire_model,
                                   grid_collective_bytes, CostReport)
