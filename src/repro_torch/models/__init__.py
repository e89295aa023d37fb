"""Model configurations (``config``), the dense decoder (``model``) and the
converter from the reference's parameter tree (``convert``)."""
