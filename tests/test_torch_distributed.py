"""A genuine two-process cluster of the port (torch.distributed over gloo
on the CPU), the counterpart of tests/test_distributed.py: two spawned
ranks join through the METERELF_* contract (initialize_distributed),
make a mesh spanning both (make_mesh: one CPU replica each, mesh size
2), shard their halves of 8 synthetic crops (shard_host_batch), decode
them (data_parallel_decoder) and reduce the metrics across the process
boundary (aggregate_metrics: one all_reduce). The ranks import no JAX:
this file is their program too (``python tests/test_torch_distributed.py
PARAMS``, run only by the test with the environment set), and it makes
importing jax or the JAX package fail there.

The parent holds the ranks' replicated aggregates equal bit for bit, and
their local results, concatenated, to the JAX package's single-process
decode of the same 8 crops: every field bit for bit, match_val within
the rtol 1e-4 of tests/fuzz_frames.py (the JAX package scores with its
CPU matmul formulation; see test_torch_mesh.py); the aggregate to the
JAX aggregate_metrics over two devices, bit for bit. The run has its
own limit of LIMIT_S seconds.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_LOCAL = 4
LIMIT_S = 120
FIELDS = ("err", "first_bad_dial", "unreadable_bits", "match_val",
          "match_x", "match_y", "dial_pos", "readable", "value", "converged")


def _positions():
    """The global batch's dial positions (row = 4 * rank + i)."""
    return [[(p * N_LOCAL + i + d * 1.7) % 10 for d in range(4)]
            for p in range(2) for i in range(N_LOCAL)]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(rank: int, port: int, yml: str) -> subprocess.Popen:
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": REPO,
        "METERELF_DEVICE": "cpu",
        "METERELF_DISTRIBUTED": "1",
        "METERELF_COORDINATOR": f"127.0.0.1:{port}",
        "METERELF_NUM_PROCS": "2",
        "METERELF_PROC_ID": str(rank),
        "OMP_NUM_THREADS": "2",
    })
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), yml], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_two_process_distributed_decode(tmp_path):
    from meterelf_tpu.params import Params as JParams
    from meterelf_tpu.parallel import mesh as j_mesh
    from meterelf_tpu.pipeline.decode import MeterDecoder as JaxDecoder
    from meterelf_tpu_torch import synthetic

    import jax

    yml = synthetic.DEFAULT_CAMERA.write_params(str(tmp_path))
    t0 = time.monotonic()
    port = _free_port()
    procs = [_spawn(0, port, yml), _spawn(1, port, yml)]
    outs = []
    try:
        for p in procs:
            left = max(1.0, LIMIT_S - (time.monotonic() - t0))
            out, err = p.communicate(timeout=left)
            assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert time.monotonic() - t0 < LIMIT_S

    outs.sort(key=lambda r: r["process"])
    assert [r["process"] for r in outs] == [0, 1]
    assert all(r["mesh_size"] == 2 and r["global_rows"] == 2 * N_LOCAL
               and r["jax_loaded"] == [] for r in outs)
    for key in ("n_ok", "n_err", "mean_hex"):
        assert outs[0][key] == outs[1][key], key

    crops = synthetic.DEFAULT_CAMERA.render_crops(_positions())
    jdec = JaxDecoder(JParams.load(yml), exact=True)
    ref = jdec.decode_numpy(crops, np.ones(len(crops), bool))
    for f in FIELDS:
        got = np.array(outs[0]["local"][f] + outs[1]["local"][f])
        want = np.asarray(getattr(ref, f))
        if f == "match_val":
            np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=f)
        elif want.dtype.kind == "f":
            np.testing.assert_array_equal(
                got.astype(want.dtype).view(np.uint64 if want.itemsize == 8
                                            else np.uint32),
                want.view(np.uint64 if want.itemsize == 8 else np.uint32),
                err_msg=f)
        else:
            np.testing.assert_array_equal(got, want, err_msg=f)
    jmesh = j_mesh.make_mesh(jax.devices("cpu")[:2])
    n_ok, n_err, mean = j_mesh.aggregate_metrics(ref.value, ref.err, jmesh)
    assert (outs[0]["n_ok"], outs[0]["n_err"]) == (int(n_ok), int(n_err))
    assert outs[0]["mean_hex"] == float(mean).hex()
    assert outs[0]["n_ok"] == int((ref.err == 0).sum()) > 0


def _rank_main(yml: str) -> None:
    """One rank: join, decode this rank's half, reduce, print JSON."""
    sys.modules["jax"] = None            # importing either now fails
    sys.modules["meterelf_tpu"] = None
    sys.path.insert(0, REPO)
    import torch.distributed as dist

    from meterelf_tpu_torch import synthetic
    from meterelf_tpu_torch.params import Params
    from meterelf_tpu_torch.parallel.mesh import (aggregate_metrics,
                                                  data_parallel_decoder,
                                                  initialize_distributed,
                                                  make_mesh,
                                                  shard_host_batch,
                                                  shutdown_distributed)
    from meterelf_tpu_torch.pipeline.decode import MeterDecoder

    assert initialize_distributed() is True
    assert dist.get_backend() == "gloo"
    mesh = make_mesh(["cpu"])
    rank = mesh.rank
    crops = synthetic.DEFAULT_CAMERA.render_crops(_positions())
    crops = crops[rank * N_LOCAL:(rank + 1) * N_LOCAL]
    dec = MeterDecoder(Params.load(yml), device="cpu")
    arr = shard_host_batch(crops, mesh)
    res = data_parallel_decoder(dec, mesh)(arr, np.ones(N_LOCAL, bool))
    agg = aggregate_metrics(res.value, res.err, mesh)
    print(json.dumps({
        "process": rank,
        "mesh_size": mesh.size,
        "global_rows": arr.shape[0],
        "n_ok": int(agg.n_ok),
        "n_err": int(agg.n_err),
        "mean_hex": float(agg.mean).hex(),
        "local": {f: np.asarray(getattr(res, f)).tolist() for f in FIELDS},
        "jax_loaded": [m for m, v in sys.modules.items() if v is not None
                       and m.split(".")[0] in ("jax", "meterelf_tpu")],
    }), flush=True)
    shutdown_distributed()


if __name__ == "__main__":
    _rank_main(sys.argv[1])
