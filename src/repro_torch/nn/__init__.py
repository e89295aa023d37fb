"""Neural-network layers of the port: primitives (``layers``), attention
(``attention``), and the argument dataclasses of the MoE, SSM and xLSTM
layers that the model configurations name (``moe``, ``ssm``, ``xlstm``;
their layers are ported in later slices)."""
