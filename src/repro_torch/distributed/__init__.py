"""Data parallelism, ZeRO sharding, compressed gradient collectives and the
pipeline schedule IR: the port of ``repro.distributed``."""
