"""The plain reference against the port's plain CPU path, and the check's
control."""

import numpy as np
import pytest
import torch

from benchmark import check, harness, reference
from benchmark.tests.conftest import (
    TINY_CELL,
    HostStandIn,
    tiny_config,
    tiny_traffic,
)


@pytest.mark.parametrize("charge,allow_shift", [(2, True), (3, True),
                                                (2, False)])
def test_reference_equals_the_ports_plain_greedy(charge, allow_shift):
    from ann_solo_tpu_torch.ops.shifted_dot import (
        greedy_assignment,
        pair_score_matrix,
    )

    gen = torch.Generator()
    gen.manual_seed(charge)
    p, k = 64, 30
    c_mz = torch.sort(100 + 60 * torch.rand((p, k), generator=gen)).values
    # Queries: library peaks moved by noise, some by a shift of delta / z.
    delta = torch.randint(-40, 40, (p, 1), generator=gen).float()
    c_ann = torch.randint(0, charge + 1, (p, k), generator=gen,
                          dtype=torch.int32)
    moved = torch.where((c_ann >= 1) & (torch.rand((p, k), generator=gen)
                                        < 0.5),
                        delta / c_ann.clamp(min=1), 0.0)
    q_mz = torch.sort(c_mz + moved + 0.01 * torch.randn(
        (p, k), generator=gen)).values
    q_int = torch.rand((p, k), generator=gen)
    c_int = torch.rand((p, k), generator=gen)
    # Ties: equal intensities on some rows.
    c_int[::7] = 0.5
    c_prec = 400 + 400 * torch.rand(p, generator=gen)
    q_prec = c_prec + delta[:, 0] / charge
    args = (q_mz, q_int, q_prec, c_mz, c_int, c_ann, c_prec)
    score, matches = reference.score_pairs(*args, charge, 0.05, allow_shift,
                                           block=16)
    charges = torch.full((p,), charge, dtype=torch.int32)
    total, mq, mc = greedy_assignment(pair_score_matrix(
        q_mz, q_int, c_mz, c_int, c_ann, q_prec, c_prec, charges, 0.05,
        charge + 1, allow_shift))
    assert np.array_equal(score, total.numpy())
    for r in range(p):
        sel = mq[r] >= 0
        want = np.stack([mq[r][sel].numpy(), mc[r][sel].numpy()], 1)
        assert np.array_equal(matches[r], want)


def test_a_run_on_the_cpu_is_correct(tiny_root):
    out = harness.run_cell(tiny_root, TINY_CELL, 2 ** 31 + 11, 0.3, False,
                           HostStandIn(), 0.0)
    assert out["correct"] is True
    assert out["checks"]["score_gap"]["value"] == 0.0
    assert out["checks"]["answers_differ"]["value"] == 0.0
    assert out["checks"]["rescore_missed"]["value"] == 0.0


def test_the_control_fails_the_check():
    """The reference in the program's place, its entries in bfloat16, is
    not correct at the real cells' limits."""
    cfg = tiny_config()
    gen = torch.Generator()
    gen.manual_seed(9)
    from benchmark import workload

    lib = workload.make_library(gen, cfg, torch.device("cpu"))
    traffic = tiny_traffic("self")
    traffic["batch"] = 256
    pool = workload.make_pool(gen, lib, cfg, traffic)
    # The program answers each query with its source row, scored exactly,
    # among candidates that hold it and seven other rows.
    answers = []
    for b, batch in enumerate(pool):
        rows = np.arange(64)
        src = batch.source[rows]
        others = torch.randint(0, lib.mz.shape[0], (64, 7), generator=gen)
        cands = torch.cat([torch.as_tensor(src)[:, None], others], 1).to(
            torch.int32)
        blank = [check.Answer(b, int(r), 0, 0.0, 0, None) for r in rows]
        score, matches = check._pairs(blank, src, pool, lib, cfg,
                                      torch.float32)
        due, _ = check._expected(blank, pool, lib, cfg)
        answers += [check.Answer(b, int(r), int(src[i]), float(score[i]),
                                 int(due[i]), matches[i], cands[i])
                    for i, r in enumerate(rows)]
    limits = workload.load_limits(workload.ROOT, "iprg2012_c2_131k.self")
    program = check.compare(answers, pool, lib, cfg, 9, 64)
    assert check.verdict(program, limits["limits"])
    assert program["rescore_missed"] == 0.0
    control = check.compare(check.control_answers(answers, pool, lib, cfg),
                            pool, lib, cfg, 9, 64)
    assert not check.verdict(control, limits["limits"])
    assert control["score_gap"] > limits["limits"]["score_gap"]
