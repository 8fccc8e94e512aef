"""Write tests/torch_golden_dynamic_toy.npz: vfi_tpu's side of tests/test_torch_dynamic.py.

    JAX_PLATFORMS=cpu python tests/make_torch_dynamic_golden.py

On the inputs that test module makes (its constants, ``clip``,
``model_params``, ``step_variables`` and a seeded VGG16 ``.npz``), on the CPU:

  * ``fwd/<model>/<KTF>/<key>``: vfi_tpu's ``apply(..., lengths=)`` of each
    of the twelve classes (``SCTForward_train``: Forward's ``forward_train``)
    on the packed clip, at each of ``LENGTHS``, with Random and RandomB's
    uniforms pinned to ``ORDER_UNIFORMS``;
  * ``mcnet_skip/<field>``: vfi_tpu's ``MCNet`` with a per-row
    ``warmup_skip`` of [0, 2], time-major NHWC, under the port's field names;
  * ``step/<setup>/<KTF>/terms/<name>`` and ``.../g|d/<flax path>``: the
    terms of vfi_tpu's ``train_step_dynamic`` from the setup's seeded state
    and the update it made to the generator's and discriminator's params
    (float16; the params after the step are the seeded ones plus it);
    ``step/slomo_static/<KTF>/...``: vfi_tpu's static SloMo ``train_step``
    at the lengths where T < max_T;
  * ``fingerprint``: ``test_torch_dynamic.fingerprint`` of those inputs.

Regenerate only if vfi_tpu, ``random_jax_params``, ``random_vgg16_npz`` or
the test's inputs change.  Not collected by pytest.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import types

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tests import test_torch_dynamic as td  # noqa: E402
from vfi_tpu.models import sct as jsct  # noqa: E402
from vfi_tpu.models.registry import create_model  # noqa: E402
from vfi_tpu.nn.discriminator import SNDiscriminator  # noqa: E402
from vfi_tpu.nn.mcnet import MCNet  # noqa: E402
from vfi_tpu.ops.dynamic import pack_context  # noqa: E402
from vfi_tpu.train import dynamic_env, environments  # noqa: E402
from vfi_tpu.utils.config import TrainConfig  # noqa: E402
from vfi_tpu_torch.nn.vgg import random_vgg16_npz  # noqa: E402

ROLLOUT_FIELDS = ("pred", "dyn", "cont", "res1", "res2", "res3")  # the port's names of vfi_tpu's RolloutStep


def _flat(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _pin_uniforms():
    """vfi_tpu.models.sct's ``jax.random.uniform`` returns ORDER_UNIFORMS."""
    rand = types.SimpleNamespace(**{k: getattr(jax.random, k) for k in dir(jax.random) if not k.startswith("__")})
    rand.uniform = lambda key, shape: jnp.asarray(td.ORDER_UNIFORMS[: shape[0], : shape[1]])
    fake = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax) if not k.startswith("__")})
    fake.random = rand
    jsct.jax = fake


def forwards() -> dict:
    out = {}
    x = jnp.asarray(td.clip())
    for name in td.FORWARDS:
        base = name.removesuffix("_train")
        model = create_model(json.dumps(td.MODELS[base]))
        params = td.model_params(base)
        for ktf in td.LENGTHS:
            lengths = tuple(jnp.int32(v) for v in ktf)
            p, m, f = pack_context(x, *lengths, td.MAX_K, td.MAX_T, td.MAX_F)
            kw = dict(lengths=lengths, rngs={"sample": jax.random.PRNGKey(0)})
            if name.endswith("_train"):
                got = model.apply({"params": params}, td.MAX_T, p, f, m, method="forward_train", **kw)
            else:
                got = model.apply({"params": params}, td.MAX_T, p, f, **kw)
            for key, a in got.items():
                out[f"fwd/{name}/{td._ktf_name(ktf)}/{key}"] = np.asarray(a)
    return out


def mcnet_skip() -> dict:
    x = td.clip()
    g = (x + 1.0) / 2.0
    diff, xt = g[:, 1:5] - g[:, :4], x[:, 4]
    params = td.model_params("MCNet")["mcnet"]
    got = MCNet(8, 1).apply({"params": params}, 2, jnp.asarray(diff), jnp.asarray(xt),
                            warmup_skip=jnp.asarray([0, 2]))
    return {f"mcnet_skip/{k}": np.asarray(a) for k, a in zip(ROLLOUT_FIELDS, got)}


def _env(setup: str, vgg: str, static: bool = False):
    name, cfg_kw = td.STEPS[setup]
    model = create_model(json.dumps(td.MODELS[name]))
    if name == "SloMo":
        cfg = TrainConfig(**cfg_kw, vgg16_weights=vgg)
        make = environments.create_training_environment if static else dynamic_env.create_dynamic_environment
        return make(model, cfg)
    env = {"TAI": dynamic_env.DynamicTAIEnvironment, "MCNet": dynamic_env.DynamicMCNetEnvironment,
           "SCTForward": dynamic_env.DynamicSCTEnvironment}[name](model, TrainConfig(**cfg_kw))
    env.discriminator = SNDiscriminator(window_size=env.cfg.disc_window_size, df_dim=env.cfg.df_dim, Ip=env.cfg.Ip)
    return env


def step(setup: str, ktf, vgg: str, static: bool = False) -> dict:
    env = _env(setup, vgg, static)
    g0, d0 = td.step_variables(setup)
    gp = jax.tree.map(jnp.asarray, g0)
    kw = dict(step=jnp.zeros((), jnp.int32), g_params=gp, g_opt=env.g_tx().init(gp), rng=jax.random.PRNGKey(0))
    if d0 is not None:
        dp, dsn = (jax.tree.map(jnp.asarray, d0[k]) for k in ("params", "sn"))
        kw.update(d_params=dp, d_sn=dsn, d_opt=env.d_tx().init(dp))
    state = environments.TrainState(**kw)
    x = td.clip()
    if static:
        K, T, F = ktf
        state, terms = env.train_step(state, K, T, F, x[:, : K + T + F])
    else:
        state, terms = env.train_step_dynamic(state, jnp.asarray(x), jnp.asarray(ktf, jnp.int32))
    tag = f"step/{setup}{'_static' if static else ''}/{td._ktf_name(ktf)}/"
    out = {f"{tag}terms/{k}": np.float64(v) for k, v in terms.items()}
    out.update({f"{tag}g/{k}": (a - b).astype(np.float16) for (k, a), (_, b) in
                zip(_flat(jax.device_get(state.g_params)), _flat(g0))})
    if d0 is not None:
        out.update({f"{tag}d/{k}": (a - b).astype(np.float16) for (k, a), (_, b) in
                    zip(_flat(jax.device_get(state.d_params)), _flat(d0["params"]))})
    return out


def main() -> None:
    _pin_uniforms()
    with tempfile.TemporaryDirectory(prefix="dynamic_golden_") as tmp:
        vgg = random_vgg16_npz(os.path.join(tmp, "vgg16.npz"), seed=td.VGG_SEED)
        out = {"fingerprint": np.asarray(td.fingerprint(vgg))}
        out.update(forwards())
        out.update(mcnet_skip())
        for setup in td.STEPS:
            for ktf in td.LENGTHS:
                out.update(step(setup, ktf, vgg))
                if setup == "slomo" and ktf[1] < td.MAX_T:
                    out.update(step(setup, ktf, vgg, static=True))
    path = os.path.join(REPO, "tests", "torch_golden_dynamic_toy.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path}: {len(out)} arrays, {os.path.getsize(path)} bytes")


if __name__ == "__main__":
    main()
