"""decode.aten_ops_per_batch (ops): aten operators the host issued a batch
in the traced window, nested ones included (the eager glue's launch
work)."""


def read(w):
    return w.n_host("aten::") / w.units
