"""Neural-network layers of the port: primitives (``layers``), attention
(``attention``: GQA and MLA), the MoE layer (``moe``), Mamba2's SSD layer
(``ssm``) and xLSTM's mLSTM and sLSTM layers (``xlstm``)."""
