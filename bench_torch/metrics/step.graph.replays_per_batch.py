"""step.graph.replays_per_batch (runs): runs of the program's span
``meterelf.step.graph`` a batch, one for each step that replayed its CUDA
graphs (pipeline/graphs.py): 1.0 when every batch of the window
replayed; None where the span did not run."""
from harness import spans


def read(w):
    runs = spans.table(w).runs.get("meterelf.step.graph")
    return runs / w.units if runs else None
