"""The share of the pixels the tiled paths ran that are the image's, %:
100 x the StageTimer's ``count/tile_image_px`` over its ``count/tile_px``
(tiles x (tile + 2 halo)^2, counted where every tiled path cuts its grid)
over the measured window. The rest is the grid's padding and the halos."""


def read(ctx):
    image = ctx.stages.get("count/tile_image_px", (0.0, 0))[0]
    run = ctx.stages.get("count/tile_px", (0.0, 0))[0]
    return 100.0 * image / run if run > 0 else None
