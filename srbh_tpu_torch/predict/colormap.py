"""7-class build colormap for prediction GeoTIFFs (utils/preprocess.py:167-175)."""

CMAP = {
    0: (0, 0, 0, 255),
    1: (0, 40, 255, 255),      # blue  (ref 40.5 -> int)
    2: (0, 212, 255, 255),     # cyan  (ref 212.5)
    3: (125, 255, 121, 255),   # green (ref 121.77)
    4: (255, 229, 0, 255),     # yellow (ref 229.81)
    5: (255, 70, 0, 255),      # orange (ref 70.55)
    6: (127, 0, 0, 255),       # dark red (ref 127.5)
}
