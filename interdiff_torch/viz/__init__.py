"""Host-side rendering of clips to gifs (numpy, Pillow or imageio, and
matplotlib for the skeleton track)."""
