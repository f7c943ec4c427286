from .graph import BINOP_TYPES, LEAF_TYPES, Material, NodeArgument, NodeType, SceneGraph
from .partition import partition_tape
from .tape import OP_DIFF, OP_INTERSECT, OP_PUSH, OP_UNION, CompiledTape, compile_tape

__all__ = [
    "BINOP_TYPES",
    "LEAF_TYPES",
    "Material",
    "NodeArgument",
    "NodeType",
    "SceneGraph",
    "partition_tape",
    "OP_DIFF",
    "OP_INTERSECT",
    "OP_PUSH",
    "OP_UNION",
    "CompiledTape",
    "compile_tape",
]
