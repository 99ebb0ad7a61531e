"""Checkpointed alignment workflow (reference analog: src/c++/lib/workflow
AlignWorkflow and bin/isaac-align).

This package imports nothing on its own: the output process imports
`workflow.output_proc` and must not pull torch in through `workflow.align`.
"""
