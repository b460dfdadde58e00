"""End-to-end inference: amodal depth (`amodal_pipeline`) and the
generative DepthFM family (`depthfm_pipeline`)."""
