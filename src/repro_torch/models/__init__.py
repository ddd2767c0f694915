"""The LM model zoo (``model.build``): the decoder for the dense, MoE and VLM
families, xLSTM and the Mamba2 / shared-attention hybrid (Zamba2), their
layers and the converter of the reference's parameters."""
