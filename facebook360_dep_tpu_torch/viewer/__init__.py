"""Interactive 6DoF viewer (GlViewer equivalent): the host serves the fused
stream, the browser's WebGL2 runs the RigScene pipeline. Host only: the
server computes with CPU tensors and never touches the card."""
