"""The flash kernel's training route under a device mesh, emulated on
the CPU: a one-rank gloo process group and a (1, 1) ("data", "model")
mesh (the card's ``mesh`` phase at world size 1), the state placed by
``reshard`` under the train rules.  ``attention`` then runs the kernel
on each rank's local shards inside its island: the emulated flash
kernel (``test_torch_kernel_emulation.py``'s build, through the real
wrapper) is launched twice a layer (forward and remat recompute), and
the loss and every gradient equal the unplaced kernel route's.  The
selective-scan kernel does the same inside falcon-mamba's scan island
(``models/ssm.py``).  A DTensor handed to a kernel wrapper is refused.
"""
import dataclasses
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs as tconfigs
from repro_torch.dist.sharding import MeshRules, use_mesh
from repro_torch.kernels.flash_attention import flash
from repro_torch.kernels.ssm_scan import scan
from repro_torch.models.model import get_model
from repro_torch.models.params import init_params
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.elastic import gather, reshard
from repro_torch.train.train_step import loss_and_grads
from test_torch_kernel_emulation import (  # noqa: F401  (fixtures)
    _one_thread, cuda_path_on_cpu, emulated)


@pytest.fixture(scope="module")
def host_mesh():
    from repro_torch.launch.mesh import make_host_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        yield make_host_mesh(1)
    finally:
        dist.destroy_process_group()


def test_emulated_flash_in_the_sharded_step(host_mesh, cuda_path_on_cpu):
    cfg = dataclasses.replace(tconfigs.get("qwen2-0.5b").reduced(),
                              dtype="float32", d_head=64)
    model = get_model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 97))
                            .astype(np.int32))
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    want_loss, want = loss_and_grads(model, params, batch)
    rules = MeshRules(batch_axes=("data",), fsdp_axes=("data",),
                      cache_seq_axes=("model",))
    with use_mesh(host_mesh, rules):
        placed = reshard(params, model.param_pspecs(rules), host_mesh)
        n0 = flash.KERNEL.launches
        loss, grads = loss_and_grads(model, placed, batch)
        assert flash.KERNEL.launches - n0 == 2 * cfg.n_layers
    assert torch.equal(loss, want_loss)
    for got, w in zip(tree_leaves(gather(grads)), tree_leaves(want)):
        assert torch.equal(got, w)


def test_emulated_scan_in_the_sharded_step(host_mesh, cuda_path_on_cpu):
    """falcon-mamba reduced (2 layers, d_in 128, N 8), S 40, B 2: the
    emulated scan inside the island twice a layer (``SelectiveScan``'s
    forward and the remat recompute), the loss and every gradient equal
    to the unplaced kernel route's."""
    cfg = dataclasses.replace(tconfigs.get("falcon-mamba-7b").reduced(),
                              dtype="float32")
    model = get_model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 41))
                            .astype(np.int32))
    batch = {"tokens": toks[:, :-1].contiguous(),
             "labels": toks[:, 1:].contiguous()}
    want_loss, want = loss_and_grads(model, params, batch)
    rules = MeshRules(batch_axes=("data",), fsdp_axes=("data",))
    with use_mesh(host_mesh, rules):
        placed = reshard(params, model.param_pspecs(rules), host_mesh)
        n0 = scan.KERNEL.launches
        loss, grads = loss_and_grads(model, placed, batch)
        assert scan.KERNEL.launches - n0 == 2 * cfg.n_layers
    assert torch.equal(loss, want_loss)
    for got, w in zip(tree_leaves(gather(grads)), tree_leaves(want)):
        assert torch.equal(got, w)


def test_kernel_wrapper_refuses_a_dtensor(host_mesh):
    from torch.distributed.tensor import distribute_tensor
    q = distribute_tensor(torch.zeros(1, 8, 2, 16), host_mesh)
    with pytest.raises(TypeError, match="local tensors"):
        flash.launch(q, q, q, True)
