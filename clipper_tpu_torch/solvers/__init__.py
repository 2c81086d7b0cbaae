from clipper_tpu_torch.solvers.msrc import (find_dense_clique, round_solution,
                                            solve_msrc)
from clipper_tpu_torch.solvers.msrc_flat import (flat_solve_single,
                                                 solve_batched)
from clipper_tpu_torch.solvers.extract import CliqueExtraction, extract_cliques

__all__ = ["find_dense_clique", "round_solution", "solve_msrc",
           "flat_solve_single", "solve_batched",
           "CliqueExtraction", "extract_cliques"]
