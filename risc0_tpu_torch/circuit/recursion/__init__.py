"""Recursion circuit (the STARK-verifier VM) on torch: taps, constraint
bytecode, preflight, witness generation and proving (counterpart of
``risc0_tpu/circuit/recursion``).

The circuit data are the reference's extracted artifacts under
``assets.RECURSION_DATA``; the PolyExtStep interpreter follows the
documented executor semantics (risc0/zkp/src/adapter.rs:152-401).
"""
