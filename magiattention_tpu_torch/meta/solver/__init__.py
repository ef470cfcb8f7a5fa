"""Planning solvers: dispatch load balancing, CP comm/calc planning, overlap.

The port's copy of ``magiattention_tpu/meta/solver/__init__.py`` (numpy only, imports
rewired).
"""
