"""The dense decoder in torch math (counterpart of ``repro.models``)."""
