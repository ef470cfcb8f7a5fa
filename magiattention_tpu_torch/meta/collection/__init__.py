"""Planning outputs: DispatchMeta, CalcMeta, CommMeta.

The port's copy of ``magiattention_tpu/meta/collection/__init__.py`` (numpy only, imports
rewired).
"""
