"""The model stack of `repro_torch`: configs -> layers, attention, SSD ->
model assembly.  Counterpart of `repro.models`."""
