"""Globe tiling: 3x3 degree grid with hand-tuned special tiles.

Mirrors the reference's tile map exactly (globe_index.c:13-399) so the
tar1090 web app's globe_NNNN tile fetches resolve identically:
- 66 special tiles (index 0..65) covering oceans/low-density areas
- everything else falls into the 3-degree grid, index =
  (lat+90)/3 * 121 + (lon+180)/3 + 1000
"""

from __future__ import annotations

GLOBE_INDEX_GRID = 3
GLOBE_LAT_MULT = 360 // GLOBE_INDEX_GRID + 1  # 121
GLOBE_MIN_INDEX = 1000
GLOBE_MAX_INDEX = 180 // GLOBE_INDEX_GRID * GLOBE_LAT_MULT + GLOBE_MIN_INDEX

# (south, west, north, east) — order preserved from init_globe_index
SPECIAL_TILES: list[tuple[int, int, int, int]] = [
    (60, -126, 90, 0),      # Arctic
    (60, 0, 90, 150),
    (51, 150, 90, -126),    # Alaska and Chukotka
    (9, 150, 51, -126),     # North Pacific
    (51, -126, 60, -69),    # Northern Canada
    (45, -120, 51, -114),   # Northwest USA
    (45, -114, 51, -102),
    (45, -102, 51, -90),
    (45, -90, 51, -75),     # Eastern Canada
    (45, -75, 51, -69),
    (42, 12, 48, 18),       # Balkan
    (42, 18, 48, 24),
    (48, 18, 54, 24),       # Poland
    (54, 12, 60, 24),       # Sweden
    (54, 3, 60, 12),        # Denmark
    (54, -9, 60, 3),        # Northern UK
    (42, -9, 48, 0),        # Bay of Biscay
    (42, 24, 51, 51),       # West Russia
    (51, 24, 60, 51),
    (30, 51, 60, 90),       # Central Russia
    (30, 90, 60, 120),      # East Russia
    (30, 120, 39, 129),     # Koreas and Japan
    (30, 129, 39, 138),
    (30, 138, 39, 150),
    (39, 120, 60, 150),
    (9, 90, 21, 111),       # Vietnam
    (21, 90, 30, 111),      # South China
    (9, 111, 24, 129),      # South China / ICAO special use
    (24, 111, 30, 120),
    (24, 120, 30, 129),
    (9, 129, 30, 150),      # Pacific south of Japan
    (9, 51, 30, 69),        # Persian Gulf / Arabian Sea
    (9, 69, 30, 90),        # India
    (-90, -30, 9, 51),      # South Atlantic / South Africa
    (-90, 51, 9, 111),      # Indian Ocean
    (-90, 111, -18, 160),   # Australia
    (-18, 111, 9, 160),
    (-90, 160, -42, -90),   # South Pacific and NZ
    (-42, 160, 9, -90),
    (-9, -90, 9, -42),      # North South America
    (-90, -90, -9, -63),    # South South America west
    (-21, -63, -9, -42),    # east
    (-90, -63, -21, -42),
    (-90, -42, 9, -30),
    (9, -126, 33, -117),    # Guatemala / Mexico
    (9, -117, 30, -102),
    (9, -102, 27, -90),     # western gulf + east mexico
    (24, -90, 30, -84),     # Eastern Gulf of Mexico
    (9, -90, 18, -69),      # south of Jamaica
    (18, -90, 24, -69),     # Cuba / Haiti
    (36, 6, 42, 18),        # Mediterranean
    (36, 18, 42, 30),
    (9, -9, 39, 6),         # North Africa
    (9, 6, 36, 30),
    (9, 30, 42, 51),        # Middle East
    (24, -75, 39, -69),     # west of Bermuda
    (9, -69, 30, -33),      # North Atlantic
    (30, -69, 60, -33),
    (9, -33, 30, -9),
    (30, -33, 60, -9),
]


def globe_index(lat: float, lon: float) -> int:
    """globe_index (globe_index.c:367-399)."""
    grid = GLOBE_INDEX_GRID
    glat = grid * int((lat + 90) / grid) - 90
    glon = grid * int((lon + 180) / grid) - 180

    for i, (south, west, north, east) in enumerate(SPECIAL_TILES):
        if south <= glat < north:
            if west < east and west <= glon < east:
                return i
            if west > east and (glon >= west or glon < east):
                return i

    i = (glat + 90) // grid
    j = (glon + 180) // grid
    res = i * GLOBE_LAT_MULT + j + GLOBE_MIN_INDEX
    return res if res <= GLOBE_MAX_INDEX else 0
