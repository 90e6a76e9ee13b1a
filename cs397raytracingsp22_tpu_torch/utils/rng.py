"""Draw-site addressing for the render path's counter-based RNG.

Every draw is addressed by (seed, ray_uid, site, lane): `ray_uid =
pixel_id * spp + sample_id`, and `site` names the draw site (camera
jitter, bounce 0, bounce 1, ...). Draws follow content, not buffer
position, so an image does not depend on how rays are chunked. The
generator is utils/threefry.py.
"""

# Draw-site tags. Bounces use SITE_BOUNCE0 + bounce index.
SITE_CAMERA = 0
SITE_BOUNCE0 = 1
