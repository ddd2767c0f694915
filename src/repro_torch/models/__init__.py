"""The LM model zoo's dense decoder (``model.build`` for ``family="dense"``),
its layers and the converter of the reference's parameters."""
