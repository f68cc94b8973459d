"""Crash-point sweep of the port's MoE routing program, part 1: every
Manager-role mutation site (the Manager itself, ``record_loss`` and the
program's setup, combines, commits and round cleanup), each armed once
before and once after its op, and each expert commit armed again in the
middle round. See ``tests/_torch_moe_sweep.py`` for the run and the gate;
``test_torch_moe_sweep_handler.py`` holds the Handler and executor sites."""

import pytest

import _torch_moe_sweep as S
from repro_torch.core.space import raced

SITES = [s for s in S.sweep_sites(roles=("manager",))]


def test_the_sweep_covers_the_manager_and_the_program():
    files = {s.path for s in SITES}
    assert files == {"src/repro_torch/core/manager.py", "src/repro_torch/core/program.py",
                     "src/repro_torch/programs/moe.py"}, files
    assert any("_commit_expert" in s.qualname for s in SITES)
    assert any("finish_round" in s.qualname for s in SITES)


@pytest.mark.parametrize("scheduling", ["event", "poll"])
def test_every_mutation_of_a_crash_free_run_is_a_swept_site(scheduling):
    """The crash-free runs, each mutation's (role, path, line, op)
    recorded: every one is a site of the sweep (both parts), and the run
    reaches sites of every role."""
    every = S.sweep_sites()
    issued = S.baseline(scheduling).sites
    missing = [m for m in issued if not any(S.covers(s, *m) for s in every)]
    assert not missing, missing
    assert {m[0] for m in issued} == set(S.ROLES)


@pytest.mark.parametrize("when", ["before", "after"])
@pytest.mark.parametrize("site", SITES, ids=[s.site_id for s in SITES])
def test_a_crash_at_each_manager_site_leaves_the_run_exact(site, when):
    S.arm_and_check(site, when)


COMMITS = [s for s in SITES if "_commit_expert" in s.qualname]


@pytest.mark.parametrize("when", ["before", "after"])
@pytest.mark.parametrize("site", COMMITS, ids=[s.site_id for s in COMMITS])
def test_a_crash_at_an_expert_commit_of_the_middle_round(site, when):
    """The first commit of round MID, not of round 0: the weights then
    carry two rounds of updates, and a commit applied twice or lost shows
    in every later loss."""
    def in_mid_round(_key):
        ctx = raced._get_ctx()
        return ctx is not None and ctx[0] == "stage" and ctx[1] == S.MID

    run = S.arm_and_check(site, when, keep_key=in_mid_round)
    assert run.firings, "the middle round's commit never fired"
