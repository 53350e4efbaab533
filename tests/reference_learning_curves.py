"""The reference trainers' loss curves on the CPU at chip_smoke.py's
training settings, the provenance of its learning gates
(chip_smoke.LEARNING_MAX_RATIO).

    python tests/reference_learning_curves.py superpoint 40
    python tests/reference_learning_curves.py lightglue 40
    python tests/reference_learning_curves.py cosplace 30
    python tests/reference_learning_curves.py netvlad 30

Each runs cslam_tpu's build_train_step in its main's loop (seed 0, the
same RNG order, the CLI's shapes: SuperPoint batch 16 at 64x96 from
scratch; LightGlue batch 16, K = 96, 3 layers; CosPlace 8 places x 2
views at crop 224; NetVLAD crop 128 after data_driven_init) and prints
one JSON line: every step's loss, the mean of the first and last 5,
and their ratio. Not a test: it runs minutes on the CPU.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

WINDOW = 5


def superpoint_losses(steps, seed):
    from cslam_tpu.models import train_superpoint as m
    from cslam_tpu.models.superpoint import SuperPointNet
    model = SuperPointNet(dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 96, 1)))
    tx, step = m.build_train_step(model, 1e-3, steps)
    state, losses = tx.init(params), []
    for _ in range(steps):
        batch = m._batch(rng, 16, 64, 96)
        params, state, loss, _, _ = step(params, state,
                                         tuple(map(jnp.asarray, batch)))
        losses.append(float(loss))
    return losses


def lightglue_losses(steps, seed, K=96):
    from cslam_tpu.models import train_lightglue as m
    from cslam_tpu.models.lightglue import LightGlueNet
    model = LightGlueNet(num_layers=3)
    rng = np.random.default_rng(seed)
    dummy = (jnp.zeros((K, 256)), jnp.zeros((K, 2)), jnp.ones(K),
             jnp.zeros((K, 256)), jnp.zeros((K, 2)), jnp.ones(K))
    params = model.init(jax.random.PRNGKey(seed), *dummy)
    tx, step = m.build_train_step(model, 2e-4, steps)
    state, losses = tx.init(params), []
    for _ in range(steps):
        batch = m.make_match_batch(rng, 16, K=K, noise_lo=0.4,
                                   noise_hi=0.95)
        params, state, loss = step(params, state,
                                   tuple(map(jnp.asarray, batch)))
        losses.append(float(loss))
    return losses


def cosplace_losses(steps, seed):
    from cslam_tpu.models import train_cosplace as m
    from cslam_tpu.models.cosplace import GeoLocalizationNet
    model = GeoLocalizationNet(fc_output_dim=64)
    rng = np.random.default_rng(seed)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, 224, 224, 3), jnp.float32))
    params, stats = variables["params"], variables["batch_stats"]
    tx, step = m.build_train_step(model, 1e-3, steps)
    state, losses = tx.init(params), []
    for _ in range(steps):
        world = m.make_world(int(rng.integers(2**31)), n=160)
        images, labels = m.make_batch(rng, world, 8, 2, 0.3, 0.05, 224)
        params, stats, state, loss = step(params, stats, state,
                                          jnp.asarray(images),
                                          jnp.asarray(labels))
        losses.append(float(loss))
    return losses


def netvlad_losses(steps, seed):
    from cslam_tpu.models import train_netvlad as m
    from cslam_tpu.models.netvlad import NetVLADNet
    from cslam_tpu.models.train_cosplace import make_batch, make_world
    model = NetVLADNet()
    rng = np.random.default_rng(seed)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, 128, 128, 3), jnp.float32))
    params = m.data_driven_init(model, variables["params"], rng, 128)
    tx, step = m.build_train_step(model, 1e-4, steps)
    state, losses = tx.init(params), []
    for _ in range(steps):
        world = make_world(int(rng.integers(2**31)), n=160)
        images, labels = make_batch(rng, world, 8, 2, 0.3, 0.05, 128)
        params, state, loss = step(params, state, jnp.asarray(images),
                                   jnp.asarray(labels))
        losses.append(float(loss))
    return losses


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    which, steps = argv[0], int(argv[1])
    seed = int(argv[2]) if len(argv) > 2 else 0
    t0 = time.time()
    losses = globals()[f"{which}_losses"](steps, seed)
    first = float(np.mean(losses[:WINDOW]))
    last = float(np.mean(losses[-WINDOW:]))
    print(json.dumps({"trainer": which, "steps": steps, "seed": seed,
                      "losses": losses, "first": first, "last": last,
                      "ratio": last / first,
                      "seconds": time.time() - t0}))


if __name__ == "__main__":
    main()
