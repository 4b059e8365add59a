"""chip_smoke.py's judge where the plain version itself is unstable: one
env where the plain f32 version lands on float64's other branch must not
set the limits of every other env.

The limits are a multiple of the plain version's worst error against
float64. The judge gives the plain version's worst envs the test it gives
the kernel's failing envs (float64's own move under 1e-6 relative input
perturbations, at least half the plain version's miss, on the state or the
contact forces) and takes such an env out of the limits, judging it by its
own raised limits; a stable worst env keeps setting them. Envs taken out
and excused count under the one cap of 4 in 4096. Batches and stub reruns
as in tests/test_torch_judge.py.
"""

import pytest
import torch

import chip_smoke as cs
from test_torch_judge import N, Rerun, batch, judged

torch.set_num_threads(1)

P = 2313       # the plain version's worst env
PLANTED = 1234  # a stable env given a kernel miss


def step7(got, plain, cpu, want):
    """A 9b step on the card: the plain version 0.485 off float64 on the
    state in one env (a state limit of 0.97 under the old rule), the
    kernel on float64's branch there."""
    plain[0][P, 0] = want[0][P, 0] + 0.485
    cpu[0][P, 0] = want[0][P, 0] + 0.3
    got[0][P] = want[0][P]


def step23(got, plain, cpu, want):
    """Another: limits of 2.17 on the state and 500.6 N on the contact
    forces from the plain version's one worst env."""
    want[1][P, 0] = 100.0
    plain[0][P, 0] = want[0][P, 0] + 1.085
    plain[1][P, 0] = 100.0 + 250.3 + 1e-3  # 250.3 N past rtol
    cpu[1][P, 0] = 100.0 + 200.0
    got[0][P], got[1][P] = want[0][P], want[1][P]


def plain_outliers(got, plain, want, envs, misses):
    """Envs where the plain version lands ``misses`` off float64 on the
    state, the kernel on float64's branch."""
    for k, miss in zip(envs, misses):
        plain[0][k, 0] = want[0][k, 0] + miss
        got[0][k] = want[0][k]


@pytest.mark.parametrize("case,miss", [
    (step7, (0, 3, 2e-3)),     # a state miss
    (step23, (1, 0, 0.5))],    # a contact miss, N
    ids=["step7", "step23"])
def test_planted_miss_fails_past_a_threshold_env(case, miss, capsys):
    """Float64 moves in the plain version's worst env: the env is taken
    out of the limits, and a planted kernel miss in a stable env fails.
    The old rule's limits would have passed it."""
    got, plain, cpu, want = batch()
    case(got, plain, cpu, want)
    q, col, size = miss
    got[q][PLANTED, col] += size
    rerun = Rerun({P: (0.9, 300.0) if case is step23 else (0.4, 0.5)})
    c = judged(got, plain, cpu, want, rerun)
    old = (max(cs.ATOL, 2.0 * c["plain64_err"]["state"]),
           max(cs.CONTACT_ATOL, 2.0 * c["plain64_err"]["contact"]))
    assert old == pytest.approx((0.97, cs.CONTACT_ATOL) if case is step7
                                else (2.17, 500.6), rel=1e-3)
    assert size < old[q]
    with pytest.raises(AssertionError, match=rf"once plain envs \[{P}\] were"
                       rf" taken out of the limits .*env {PLANTED}: kernel "
                       "vs float64"):
        cs.judge(c, "planted")
    assert rerun.asked == [[P], [PLANTED]]


def test_no_rerun_where_no_verdict_turns_on_the_plain_env(capsys):
    """Without the planted miss every other env is within the limits of
    the other envs: the threshold env is not rerun, the limits stay the
    old rule's, and the line says what the other envs are within."""
    got, plain, cpu, want = batch()
    step7(got, plain, cpu, want)
    rerun = Rerun({P: (0.4, 0.5)})
    c = judged(got, plain, cpu, want, rerun)
    tol_s, tol_c, excused = cs.judge(c, "step 7")
    assert rerun.asked == [] and excused == {}
    assert tol_s == pytest.approx(0.97, rel=1e-3) and tol_c == cs.CONTACT_ATOL
    assert c["limits"]["held"] == (cs.ATOL, cs.CONTACT_ATOL, cs.ATOL,
                                   cs.CONTACT_ATOL)
    out = capsys.readouterr().out
    assert "step 7: limits kernel vs plain 9.700e-01" in out
    assert (f"no plain env taken out; every other env but plain envs [{P}]"
            f" within kernel vs plain 2.000e-04 / 2.000e-03") in out


@pytest.mark.parametrize("case", [step7, step23], ids=["step7", "step23"])
def test_stable_worst_env_keeps_setting_the_limits(case, capsys):
    """Float64 held still in the plain version's worst env: its error is
    f32's own, it sets every env's limits as under the old rule, and the
    same planted misses pass."""
    got, plain, cpu, want = batch()
    case(got, plain, cpu, want)
    got[0][PLANTED, 3] += 2e-3
    got[1][PLANTED, 0] += 0.5 if case is step23 else 0.0
    rerun = Rerun()
    c = judged(got, plain, cpu, want, rerun)
    tol_s, tol_c, excused = cs.judge(c, "stable")
    assert rerun.asked == [[P]] and excused == {}
    assert (tol_s, tol_c) == c["limits"]["old"][:2]
    assert c["limits"]["new"] == c["limits"]["old"]
    assert tol_s == pytest.approx(2.0 * c["plain64_err"]["state"])
    assert "no plain env taken out" in capsys.readouterr().out


def test_over_the_cap(capsys):
    """Five plain threshold envs, one more than the cap of 4: four are
    taken out and the fifth sets the limits, as the worst env left did
    under the old rule; the line says so. And where envs that fail only
    the lower limits (float64 moving there too) find no room, the last
    plain env taken out sets the limits again: the kernel is not failed
    for the plain version's instability."""
    assert max(1, int(cs.EXCUSE_SHARE * N)) == 4
    plains = [P + i for i in range(5)]
    got, plain, cpu, want = batch()
    plain_outliers(got, plain, want, plains, [0.30, 0.29, 0.28, 0.27, 0.26])
    got[0][PLANTED, 3] += 2e-3
    rerun = Rerun({k: (0.3, 1.0) for k in plains})
    tol_s, _, excused = cs.judge(judged(got, plain, cpu, want, rerun), "cap")
    assert rerun.asked == [plains[:4]] and set(excused) == set(plains[:4])
    assert tol_s == pytest.approx(2.0 * 0.26, rel=1e-3)
    assert ("the cap of 4 env(s) taken out or excused reached: plain env(s) "
            f"[{plains[4]}] go on setting the limits"
            in capsys.readouterr().out)

    kernel = [500, 501]  # the kernel off float64's branch, float64 moving
    got, plain, cpu, want = batch()
    plain_outliers(got, plain, want, plains[:3], [0.30, 0.29, 0.28])
    for k in kernel:
        got[0][k, 0] = want[0][k, 0] + 0.35
    rerun = Rerun({k: (0.5, 1.0) for k in plains + kernel})
    tol_s, _, excused = cs.judge(judged(got, plain, cpu, want, rerun), "room")
    assert rerun.asked == [plains[:3], kernel]
    assert set(excused) == set(plains[:2])
    assert tol_s == pytest.approx(2.0 * 0.28, rel=1e-3)
    assert (f"plain env(s) [{plains[2]}] go on setting the limits"
            in capsys.readouterr().out)


def test_env_both_plain_worst_and_excused_counts_once():
    """The plain version's worst env is also a kernel env to excuse: it is
    excused once, and three more plain threshold envs fit under the cap
    of 4 beside it, so the planted miss is still caught."""
    extra = [P + 1, P + 2, P + 3]
    got, plain, cpu, want = batch()
    plain_outliers(got, plain, want, extra, [0.30, 0.29, 0.28])
    plain[0][P, 0] = want[0][P, 0] + 0.1
    cpu[0][P, 0] = want[0][P, 0] + 0.4
    got[0][P, 0] = want[0][P, 0] - 0.65  # past 1.5x the plain version's
    got[0][PLANTED, 3] += 2e-3
    rerun = Rerun({k: (0.5, 1.0) for k in [P] + extra})
    c = judged(got, plain, cpu, want, rerun)
    with pytest.raises(AssertionError, match=rf"once plain envs \[{P + 1}, "
                       rf"{P + 2}, {P + 3}\] were taken out .*env {PLANTED}:"):
        cs.judge(c, "overlap")
    assert rerun.asked == [[P], extra, [PLANTED]]


def test_env_taken_out_is_judged_by_its_own_limits():
    """A plain threshold env taken out of the limits is held to its own,
    raised by float64's move as an excused env's are: a kernel that lands
    0.6 off float64 there, past twice float64's move of 0.25, fails,
    although the old rule's limits (0.7275 from the env's own plain error)
    would pass it."""
    got, plain, cpu, want = batch()
    step7(got, plain, cpu, want)
    got[0][P, 0] = want[0][P, 0] + 0.6
    got[0][PLANTED, 3] += 2e-3
    rerun = Rerun({P: (0.25, 1e-5)})
    c = judged(got, plain, cpu, want, rerun)
    assert c["env"]["k64_s"][P] < 1.5 * c["env"]["p64_s"][P]
    with pytest.raises(AssertionError, match=rf"in plain env {P}, taken "
                       rf"out of the limits, env {P}: kernel vs float64 "
                       "6.000e-01"):
        cs.judge(c, "own limits")
    assert rerun.asked == [[P]]
