"""The mesh's all_gathers in a request's record (utils/profiling `gathers`,
`gather_bytes`), on the CPU.

  * ops/sim_step's row-range host loop, its kernels emulated in PyTorch
    ops (torch_mesh_workers.FakeSimLib) on the gloo ranks of a 1x2 mesh:
    the record counts the gathers the loop enqueued, and their bytes, as
    the gather itself saw them: K a chunk (K - 1 of the positions the next
    step reads, one of the carry's slots), over direct C calls and over
    one graph's replays (the stand-in capture, whose replay runs the
    captured body);
  * ops/graded_step's captured row-range loop (its kernels emulated,
    test_torch_graded_graph.FakeGradedLib): one gather of the whole state
    in blocks a step, counted a replay;
  * both keys 0 on one device, for simulate() and a graded solve.
"""

import pytest

from nbody_tpu_torch import SimConfig, simulate, solve_scene
from nbody_tpu_torch.parallel.spawn import run_ranks
from nbody_tpu_torch.utils import profiling
import test_torch_graded_graph as GG
import test_torch_sim_rows as R
import torch_mesh_workers as W

K = 7
CHUNKS = [(0, K), (K, 2 * K), (2 * K, 3 * K)]     # one shape, three chunks


def _jobs(precision: str) -> list:
    inp = R._inputs(precision)
    jobs = []
    for integrator, compensated in R.VARIANTS:
        kw = dict(inp["kw"], integrator=integrator, compensated=compensated)
        a = inp["a"] if integrator == "leapfrog" else None
        jobs.append((f"{integrator}/{compensated}", inp["q"], inp["v"], a,
                     inp["m0"], inp["m_half"], inp["fst"], CHUNKS, kw))
    return jobs


@pytest.mark.parametrize("graphs", [False, True], ids=["direct", "replay"])
@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_rows_record_counts_the_gathers(precision, graphs):
    out = run_ranks(W.sim_rows_gathers, 2,
                    ({"scen": 1, "body": 2}, precision, _jobs(precision),
                     graphs), timeout=120)
    size = 8 if precision == "f64" else 4
    pos = 2 * 10 * 3 * size            # k = 2 blocks of ni = 10 rows
    for rank in out:
        for label, (record, seen) in rank.items():
            kept = {"euler/False": 2, "euler/True": 4,
                    "leapfrog/False": 3, "leapfrog/True": 5}[label]
            assert record == seen, label
            assert record == (3 * K, 3 * ((K - 1) * pos + kept * pos)), \
                label


def test_graded_rows_record_counts_the_gathers():
    c, blocks = GG._rows_carry()
    seen = []
    with profiling.entry("test") as req:
        GG._run_rows(c, blocks, [(0, 3), (3, 6)], GG.FakeGradedLib(c),
                     GG.StandIn(), mine=(0,),
                     gather=lambda x: seen.append(x.numel()
                                                  * x.element_size()))
    assert len(seen) == 6 and set(seen) == {c.q.numel() * 8}
    assert (req.record["gathers"], req.record["gather_bytes"]) == \
        (6, sum(seen))


def test_no_gathers_on_one_device():
    scene = W.fuzz_scene(103, 20, 3)
    simulate(scene, n_steps=12, chunk=5, precision="f32", device="cpu")
    rec = profiling.RECORDS[-1]
    assert (rec["gathers"], rec["gather_bytes"]) == (0, 0)
    assert rec["row_steps"] == {"sim": 12}
    solve_scene(scene, SimConfig(n_steps=40), device="cpu")
    rec = profiling.RECORDS[-1]
    assert (rec["gathers"], rec["gather_bytes"]) == (0, 0)
    assert rec["chunks"] >= 1
