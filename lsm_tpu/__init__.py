"""Liquid State Machine speech classification framework on JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
adelitoo/lsm-speech-classifier:
audio -> (mel | gammatone) spectrogram -> multi-threshold hysteresis spike
encoding -> batched LIF reservoir simulation -> streaming spike statistics
-> standardized features -> multinomial logistic readout.

Everything compute-heavy is jittable, batched, and shards data-parallel
(and, for large reservoirs, model-parallel) over a `jax.sharding.Mesh`.
"""

__version__ = "0.1.0"
