"""The port's TPU.PARTITION_MODE 'auto' on the contrastive steps against
the JAX package's GSPMD step on its CPU mesh (set-up in
``tests/torch_auto_common.py``; the rules, the masked and speed steps and
the checkpoint in tests/test_torch_auto_shard.py).

2-step trajectories at data 2 x model 2 with TPU.FSDP over 4 gloo ranks
(one spawn: a ``file://`` rendezvous, a process-group timeout, a join
deadline) against JAX's auto step on 4 devices, from the same initial state
through the param bridge: Swin MoCo (window attention and MLP split over
'model', its queue, pointer and momentum encoder; MoCo's shuffle
permutation is JAX's, handed over), BYOL, SimCLR and SwAV (its queue open:
under 'auto' the queue's rows enter Sinkhorn once over the gathered batch,
as JAX's global arrays do) on Slow-R10. FSDP's threshold is lowered to 256
elements on both sides. Tolerances (float32), those of
tests/test_torch_dist.py: lr 1e-4; what each parameter, BN statistic and
momentum-encoder tensor moved within 5e-2 of JAX's move plus 1e-6 of the
tree's largest value; stats within 1e-3 of max(|JAX's|, 1), grad norm within
1e-2; queues and banks within 1e-3; the pointer equal; every rank ends with
the same whole state bit for bit.
"""

import pytest

from torch_auto_common import check_trajectory, run_cases

NAMES = ("swin_moco", "byol", "simclr", "swav")


@pytest.fixture(scope="module")
def auto_world(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("autocon4"), NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_auto_contrastive_ranks_match_jax_auto_step(auto_world, name):
    refs, outs = auto_world
    check_trajectory(refs, outs, name)
