"""Seeded recompile-hazard violations (jit-* rules). Never imported."""

import torch


def retrace_per_step(fn, xs):
    out = []
    for x in xs:
        step = torch.compile(fn)  # VIOLATION jit-in-loop
        out.append(step(x))
    return out


def build_and_call(fn, x):
    return torch.compile(fn)(x)  # VIOLATION jit-call-inline


def unhashable_static(fn):
    return torch.compile(fn, static_argnums=[0, 1])  # VIOLATION jit-static-unhashable
