"""Hash-grid encoding, MLP decoders and the scene parameter dict."""
