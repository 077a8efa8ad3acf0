"""Helpers for the tests that hold the PyTorch port (pin_slam_torch) against
the JAX package: numpy in, a JAX array and a torch tensor out."""

import numpy as np
import torch

import jax.numpy as jnp

torch.set_num_threads(1)


def both(a, jdtype=None, tdtype=None):
    """numpy array -> (jax array, torch CPU tensor) holding the same values."""
    a = np.asarray(a)
    return jnp.asarray(a, dtype=jdtype), torch.as_tensor(a.copy(), dtype=tdtype)


def np_(x):
    """jax array / torch tensor / scalar -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def small_config(Config, **over):
    """The same small-capacity configuration for either package's Config."""
    cfg = Config()
    cfg.map_capacity = 1 << 12
    cfg.local_map_capacity = 1 << 10
    cfg.buffer_size = 1 << 14
    cfg.pool_capacity = 1 << 12
    cfg.downsample_hash_size = 1 << 12
    for k, v in over.items():
        setattr(cfg, k, v)
    cfg._derive()
    return cfg


def decoder_pair(key_seed, in_dim, H):
    """A JAX DecoderParams and the port's Decoder with identical weights."""
    import jax

    from pin_slam_torch.models.decoder import decoder_from_jax
    from pin_slam_tpu.models import decoder as jdec

    p = jdec.init_decoder(jax.random.PRNGKey(key_seed), in_dim, H, 1, 1)
    return p, decoder_from_jax(p)


def pack_jax_decoder(p):
    """JAX DecoderParams -> the port's packed [W1 | b1 | W2 | b2] vector."""
    (W1, b1), = p.hidden
    W2, b2 = p.out
    return torch.as_tensor(np.concatenate([np.ravel(W1), np.ravel(b1), np.ravel(W2),
                                           np.ravel(b2)]).astype(np.float32))


def spawn_ranks(world, target, workdir, timeout=240, **kw):
    """Run ``target`` (``module:function``, a module of tests/ that imports
    no JAX at its top) with ``workdir`` in ``world`` child processes joined
    over gloo on the CPU (a file rendezvous in ``workdir``, one torch thread
    each); raises with the children's output if one fails.  Returns their
    outputs."""
    import os

    from pin_slam_torch.parallel import launch

    return launch.spawn(world, target, str(workdir), workdir=str(workdir), timeout=timeout,
                        pythonpath=[os.path.dirname(os.path.abspath(__file__))], threads=1,
                        **kw)
