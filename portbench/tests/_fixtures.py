"""Shared set-up of the benchmark's CPU tests: the tiny cells and
configurations under ``tests/data`` (not listed in BENCHMARK.json)."""

import os

import torch

from portbench import harness
from portbench.reference import lattice
from portbench.reference import model as ref_model

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
CPU = torch.device("cpu")


def load(name):
    return harness.load(name, (DATA,))


def port_model(config, model, dtype=torch.float64):
    """The reference ``model`` handed to the port on the CPU, as the
    device_md driver hands it on the card."""
    from portbench.drivers.device_md import port_model as hand

    return hand(model, config, torch.device("cpu"), dtype)


def crystal(config, reps, seed, rattle):
    pos, numbers, cell = lattice.crystal(config, reps, CPU)
    gen = ref_model.generator(CPU, seed, 1)
    pos = pos + rattle * torch.randn(pos.shape, generator=gen, dtype=pos.dtype)
    return pos, numbers, cell
