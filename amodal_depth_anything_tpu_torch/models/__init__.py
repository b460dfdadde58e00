"""DINOv2 trunk, DPT head and the AmodalDAv2 / raw DAV2 models as torch modules."""
