"""test_torch_remat.py's remat DALLE (depth 3, n 128, rotary, token
shift; JAX's ``DALLE(remat=True)``), float32: params and Adam moments
after 3 clipped-Adam steps against JAX's ``make_train_step``, at
test_torch_reversible.py's tolerances (the update's relative L2 error
within 1e-3 and each moment's within 1e-5 per tensor, losses to rtol
1e-5)."""

import torch

import test_torch_reversible as rev
from test_torch_remat import remat_case  # noqa: F401  (the fixture)

torch.set_num_threads(2)


def test_three_adam_steps_match_jax_remat(remat_case):  # noqa: F811
    config, jmodel, params = remat_case
    rev.check_three_steps(jmodel, params, rev.port(params, config),
                          [rev.batch(config, 10 + i) for i in range(3)])
