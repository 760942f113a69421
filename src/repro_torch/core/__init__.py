"""Numerical core of the port: precision policy, MCF arithmetic, the bucketed
layout and the Collage-AdamW optimizer (counterparts of ``repro.core``)."""
